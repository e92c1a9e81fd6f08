"""Running the repo's ``studies/*.yaml`` plans."""
