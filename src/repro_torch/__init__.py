"""repro_torch — the EfficientIMM engine in PyTorch with CUDA kernels for
one NVIDIA H100 (Hopper, sm_90a).

A port of the JAX package ``repro`` (the frozen reference), module for
module: ``repro_torch/core/engine.py`` is the counterpart of
``repro/core/engine.py`` and so on.  It never imports JAX or ``repro``;
its tests hold it to the reference seed for seed.

    from repro_torch.core import IMMConfig, imm
    from repro_torch.graphs import synthetic_snap
    result = imm(synthetic_snap("com-Amazon"), IMMConfig(k=50))  # cuda

Entry points run on ``cuda`` unless ``device="cpu"`` is passed; on the
CPU every kernel runs its plain PyTorch version.
"""
