"""Config composition over the repo's ``configs/`` tree, with its own YAML
reader (``yaml_lite``): the card's machine has no PyYAML."""

from irw_tpu_torch.config.compose import (
    Config,
    compose,
    expand_sweeps,
    load_yaml,
    parse_overrides,
)

__all__ = ["Config", "compose", "expand_sweeps", "load_yaml", "parse_overrides"]
