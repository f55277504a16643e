"""``python -m pedoni_tpu_torch scenario.toml -H ...`` (see cli.py)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
