"""Launchers (answers `src/repro/launch/`): process-group meshes and rank
spawning (`mesh.py`, `spawn.py`) and the CLIs — `summarize`, `stream`,
`qserve`, `autotune` and `faultrun`."""
