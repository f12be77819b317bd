"""Logical-axis sharding over `torch.distributed` device meshes (answers
`src/repro/sharding/`)."""
