"""halo2_aes_tpu_torch: the AES-128 prove -> verify path in PyTorch.

A second implementation of ``halo2_aes_tpu`` on one NVIDIA H100:
compile the AES encryption or decryption circuit, SRS setup, keygen,
witness, KZG prove with SHPLONK or GWC multiopen, verify, AES-CTR
keystream bundles (``ctr.py``), the IPA proving system
(``backend/ipa.py``), the vectorized MockProver (``circuit/mock.py``),
mini-AES (``models/aes_mini.py``), ``.srs`` files
(``backend/srs_format.py``) and the dev tools (``utils/``); the
verifier's host side is C++ (``native/``).  Plain tensor code is PyTorch; every
Pallas TPU kernel of the reference is a hand-written CUDA kernel under
``csrc/`` (``ops/cuda_field.py``, ``ops/cuda_ntt.py``,
``ops/cuda_curve.py``, and the probes' ``ops/cuda_probe.py``).

Field elements cross every public function in the reference's layout:
``(..., 16)`` 16-bit limbs in Montgomery form (R = 2^256), stored as
``torch.int32``.  The device is carried by the tensors; nothing picks a
device silently.  This package imports neither JAX nor the reference.
"""

__version__ = "0.1.0"
