"""The model zoo (answers `src/repro/models/`): shared layers, the MoE
FFN, the Mamba-2 SSD mixer, the modality stubs, the transformer's
forward / prefill / decode entry points and the input specs. Plain
PyTorch: the reference reaches no Pallas kernel here."""
