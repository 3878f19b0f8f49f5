"""Hand-written CUDA kernels for the port's hot spots (Hopper, sm_90a).

<name>.py       the kernel's ctypes launcher, its plain PyTorch version,
                its launch counter key and a note on what bounds it
csrc/           the CUDA C++ sources, built at first use (build.py)
ref.py          the plain versions under the reference's *_ref names
ops.py          dispatch: kernel on CUDA tensors, plain version on CPU
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
