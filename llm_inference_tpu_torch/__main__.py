"""``python -m llm_inference_tpu_torch`` — the CLI entry point."""

from .cli import main

raise SystemExit(main())
