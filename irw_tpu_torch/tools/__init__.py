"""Command-line tools over the port: converting pretrained weights, exporting a served model."""
