"""Process-group meshes and rank launchers (answers `src/repro/launch/`:
`mesh.py`'s tree helpers; the CLIs wait for ROADMAP item 9)."""
