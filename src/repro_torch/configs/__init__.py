"""Configs (answers `src/repro/configs/`): the dataclasses of `base.py`,
the paper's three problems and the ten model configs, and the registry."""
