"""Launchers (answers `src/repro/launch/`): process-group meshes and rank
spawning (`mesh.py`, `spawn.py`) and the CLIs — `summarize`, `stream`,
`qserve`, `autotune` and `faultrun` — and the model drivers: the step
builders (`steps.py`), `serve` and `train`, and the trainer's meshes
(`mesh.make_local_mesh`)."""
