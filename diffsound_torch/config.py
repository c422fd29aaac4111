"""argparse + JSON config merge (the reference's FLAGS pattern).

Precedence: builtin/caller defaults < --config JSON < explicit CLI.
Counterpart of `diffsound_tpu/config.py`, without the JAX compilation
cache."""

from __future__ import annotations

import argparse
import json


def parse_flags(description: str = "diffsound-torch", defaults: dict = None, argv=None):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, default=None, help="Config file")
    # Known args default to None so explicitly-passed values are
    # distinguishable from defaults: precedence is builtin/caller
    # defaults < --config JSON < explicit CLI (previously the JSON
    # merge silently clobbered an explicit `--iter`).
    parser.add_argument("-i", "--iter", type=int, default=None)
    parser.add_argument("-lr", "--learning-rate", type=float, default=None)
    flags, extra = parser.parse_known_args(argv)
    cli_explicit = {
        k: v for k, v in vars(flags).items() if k != "config" and v is not None
    }

    base = {"iter": 5000, "learning_rate": 0.01}
    if defaults:
        base.update(defaults)
    for k, v in base.items():
        if flags.__dict__.get(k) is None:
            flags.__dict__[k] = v

    if flags.config is not None:
        with open(flags.config) as f:
            for key, val in json.load(f).items():
                flags.__dict__[key] = val
    flags.__dict__.update(cli_explicit)

    # `--key value` overrides applied after the JSON merge (values parsed
    # as JSON when possible so numbers/bools round-trip).
    it = iter(extra)
    for tok in it:
        if not tok.startswith("--"):
            raise SystemExit(f"unrecognized argument: {tok}")
        key = tok[2:]
        try:
            raw = next(it)
        except StopIteration:
            raise SystemExit(f"missing value for --{key}")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        flags.__dict__[key] = val

    print("Config / Flags:")
    print("---------")
    for key, val in flags.__dict__.items():
        print(key, val)
    print("---------")
    return flags
