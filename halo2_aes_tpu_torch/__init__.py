"""halo2_aes_tpu_torch: the AES-128 prove -> verify path in PyTorch.

A second implementation of ``halo2_aes_tpu``'s main path (compile the
AES circuit, SRS setup, keygen, witness, KZG/SHPLONK prove, verify) for
one NVIDIA H100.  Plain tensor code is PyTorch; the three Pallas TPU
kernels of that path are hand-written CUDA kernels under ``csrc/``
(``ops/cuda_field.py``, ``ops/cuda_ntt.py``, ``ops/cuda_curve.py``).

Field elements cross every public function in the reference's layout:
``(..., 16)`` 16-bit limbs in Montgomery form (R = 2^256), stored as
``torch.int32``.  The device is carried by the tensors; nothing picks a
device silently.  This package imports neither JAX nor the reference.
"""

__version__ = "0.1.0"
