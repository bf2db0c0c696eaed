"""Three-tier configs: a main training config whose keys become argparse
defaults, a data config (datasets, domains, shard paths, weights) and
per-dataset Dirichlet alphas configs.

Copy of egom2p_tpu/core/config.py (reference: run_training_egom2p.py:224-239,
egom2p/data/pretrain_utils.py:30-83).  A config file may be JSON or YAML:
JSON is read with the standard library (JSON is YAML, so the same file
loads through the JAX package's yaml.safe_load too), and PyYAML is imported
only for a file that is not JSON; where it is missing, that file raises.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict, List, Optional, Tuple


def str2bool(v) -> bool:
    """Argparse-safe bool: `--flag False` means False."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("1", "true", "t", "yes", "y", "on"):
        return True
    if s in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def load_config_file(path: str):
    """A JSON or YAML config file's contents."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        pass
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"{path} is not JSON, and reading YAML needs PyYAML, which is not "
                          "installed: write the config as JSON") from e
    return yaml.safe_load(text)


def parse_args_with_config(parser: argparse.ArgumentParser, argv=None):
    """Two-stage parse: --config values become defaults, the command line
    overrides them; keys the parser does not know are printed and ignored."""
    config_parser = argparse.ArgumentParser(add_help=False)
    config_parser.add_argument("--config", default=None, type=str)
    args_config, remaining = config_parser.parse_known_args(argv)
    if args_config.config:
        cfg = load_config_file(args_config.config)
        known = {a.dest for a in parser._actions}
        unknown = set(cfg) - known
        if unknown:
            print(f"[config] ignoring unknown keys: {sorted(unknown)}")
        parser.set_defaults(**{k: v for k, v in cfg.items() if k in known})
    args = parser.parse_args(remaining)
    args.config = args_config.config
    return args


def load_data_config(path: str) -> Dict:
    return load_config_file(path)


def setup_sampling_mod_info(dataset_config: Dict, modality_info: Dict,
                            config_root: str = ".") -> Tuple[Dict, Optional[List[float]]]:
    """Per-dataset modality info with Dirichlet alphas, and the mixture's
    sampling weights (None without an alphas_config)
    (reference: egom2p/data/pretrain_utils.py:30-83)."""
    in_domains = sorted(dataset_config["in_domains"].split("-"))
    out_domains = sorted(dataset_config["out_domains"].split("-"))
    all_domains = sorted(set(in_domains) | set(out_domains))
    mod_info = copy.deepcopy({m: modality_info[m] for m in all_domains})

    alphas_config = dataset_config.get("alphas_config")
    if alphas_config is None:
        for m in mod_info:
            mod_info[m]["input_alphas"] = [0.0]
            mod_info[m]["target_alphas"] = [0.0]

        def parse(v, domains):
            parts = str(v).split("-")
            return ([float(parts[0])] * len(domains) if len(parts) == 1
                    else [float(p) for p in parts])

        # the alphas zip against the SORTED domain list, not the order the
        # config writes them in, as the reference does (pretrain_utils.py:34,
        # 53; its shipped configs list domains alphabetically)
        if dataset_config.get("input_alphas") is not None:
            for m, a in zip(in_domains, parse(dataset_config["input_alphas"], in_domains)):
                mod_info[m]["input_alphas"] = [a]
        if dataset_config.get("target_alphas") is not None:
            for m, a in zip(out_domains, parse(dataset_config["target_alphas"], out_domains)):
                mod_info[m]["target_alphas"] = [a]
        return mod_info, None
    p = alphas_config if os.path.isabs(alphas_config) else os.path.join(config_root,
                                                                         alphas_config)
    if not os.path.exists(p):
        p = alphas_config  # relative to the working directory, as the reference
    alphas = load_config_file(p)
    mixture = alphas.get("alphas_mixture", alphas)
    for m in mod_info:
        mod_info[m]["input_alphas"] = mixture[m]["input_alphas"]
        mod_info[m]["target_alphas"] = mixture[m]["target_alphas"]
        if modality_info[m]["type"] in ("seq", "seq_emb", "seq_token"):
            mod_info[m]["keep"] = mixture[m]["keep"]
    return mod_info, alphas.get("sampling_weights")


def setup_run_name(args) -> None:
    """Run name and output dir from the config's file name where they are
    'auto' (reference: egom2p/utils/run_name.py:14-27)."""
    if getattr(args, "run_name", None) == "auto":
        if args.config:
            base = os.path.splitext(os.path.basename(args.config))[0]
        else:
            base = getattr(args, "model", "run")
        args.run_name = base
    if getattr(args, "output_dir", "").endswith("auto"):
        args.output_dir = args.output_dir[: -len("auto")] + args.run_name
    if getattr(args, "wandb_run_name", None) == "auto":
        args.wandb_run_name = args.run_name
