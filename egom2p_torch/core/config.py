"""Argparse with an optional YAML config whose keys become defaults.

Copy of egom2p_tpu/core/config.py:parse_args_with_config (reference:
run_training_egom2p.py:224-239).  PyYAML is imported only when
--config is given: the port runs without it.
"""
from __future__ import annotations

import argparse


def parse_args_with_config(parser: argparse.ArgumentParser, argv=None):
    """Two-stage parse: --config YAML values become defaults, the command
    line overrides them."""
    config_parser = argparse.ArgumentParser(add_help=False)
    config_parser.add_argument("--config", default=None, type=str)
    args_config, remaining = config_parser.parse_known_args(argv)
    if args_config.config:
        import yaml
        with open(args_config.config) as f:
            cfg = yaml.safe_load(f)
        known = {a.dest for a in parser._actions}
        unknown = set(cfg) - known
        if unknown:
            print(f"[config] ignoring unknown keys: {sorted(unknown)}")
        parser.set_defaults(**{k: v for k, v in cfg.items() if k in known})
    args = parser.parse_args(remaining)
    args.config = args_config.config
    return args
