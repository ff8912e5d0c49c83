"""AES-128-CTR proving: streamed keystream proofs + public XOR (port of
``ctr.py``).

Keystream block i = AES_ENC(key, nonce || counter(i)); ciphertext =
plaintext XOR keystream.  The XOR is public bookkeeping; the proof
obligation is the batched fixed-key encryption the circuit already
proves (``models/aes128.py``), with the counter blocks as in-circuit
plaintexts and the keystream bytes exposed through the instance
column.  One layout, compiled at a fixed ``blocks_per_proof``, proves
every chunk, and the bundle verifies with ONE pairing-product check
(``verifier.verify_batch``) however many proofs it holds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def counter_blocks(nonce: bytes, start: int, count: int) -> np.ndarray:
    """(count, 16) uint8 CTR input blocks: 96-bit nonce || 32-bit
    big-endian block counter (NIST SP 800-38A / RFC 3686 layout)."""
    if len(nonce) != 12:
        raise ValueError("CTR nonce must be 12 bytes")
    if not (0 <= start and start + count <= 1 << 32):
        raise ValueError("CTR counter overflow")
    out = np.zeros((count, 16), dtype=np.uint8)
    out[:, :12] = np.frombuffer(nonce, dtype=np.uint8)
    ctr = (start + np.arange(count, dtype=np.uint64)).astype(np.uint32)
    out[:, 12:] = ctr[:, None] >> np.array([24, 16, 8, 0], np.uint32)
    return out


@dataclass
class CtrBundle:
    """A proven CTR keystream: chunked proofs + the public keystream."""

    nonce: bytes
    start: int
    n_blocks: int              # keystream blocks actually used
    blocks_per_proof: int
    keystream: np.ndarray      # (ceil(n_blocks/bpp)*bpp, 16) uint8
    proofs: list = field(default_factory=list)

    def instances(self) -> list:
        """Per-proof instance lists (the exposed keystream bytes)."""
        bpp = self.blocks_per_proof
        ks = self.keystream.reshape(-1, bpp * 16)
        return [[int(v) for v in row] for row in ks]


def prove_keystream(pk, key, nonce: bytes, n_blocks: int, *, start: int = 0,
                    mesh=None, mesh_axis: str = "dp",
                    checkpoint_dir: str | None = None,
                    progress=None) -> CtrBundle:
    """Prove ``n_blocks`` keystream blocks under ``pk`` (an AES-128
    layout compiled with expose_ciphertext=True) on the pk's device; a
    final partial chunk is padded with extra counter blocks (proving
    surplus keystream is sound and keeps one layout for every proof).
    ``mesh``, ``mesh_axis`` and ``checkpoint_dir`` go to every chunk's
    ``prove`` (on a mesh every rank calls this and gets the same
    bundle).  ``progress(i, chunks)`` is called after each proof."""
    from halo2_aes_tpu_torch.backend.prover import prove
    from halo2_aes_tpu_torch.circuit import witness

    layout = pk.layout
    if not layout.instance_ids():
        raise ValueError("CTR proving needs the keystream exposed: compile "
                         "the layout with expose_ciphertext=True")
    dev = pk.device
    bpp = layout.meta["config"].n_blocks
    chunks = -(-n_blocks // bpp)
    key_t = torch.as_tensor(np.array(key, dtype=np.uint8), device=dev)
    inst_col = layout.instance_ids()[0]
    ks_rows = []
    proofs = []
    for ci in range(chunks):
        ctrs = counter_blocks(nonce, start + ci * bpp, bpp)
        values = witness.assemble_values(
            layout, witness.build_pool(key_t, torch.as_tensor(ctrs, device=dev)))
        proofs.append(prove(pk, values, mesh=mesh, mesh_axis=mesh_axis,
                            checkpoint_dir=checkpoint_dir))
        ks_rows.append(values[inst_col, :bpp * 16].cpu().numpy()
                       .astype(np.uint8).reshape(bpp, 16))
        if progress is not None:
            progress(ci + 1, chunks)
    return CtrBundle(nonce=nonce, start=start, n_blocks=n_blocks,
                     blocks_per_proof=bpp, keystream=np.concatenate(ks_rows),
                     proofs=proofs)


def verify_bundle(vk, bundle: CtrBundle, multiopen: str = "shplonk") -> bool:
    """One pairing-product check for the whole bundle; each proof's
    instance bytes are re-derived from the public keystream, so a
    tampered keystream fails even when its proofs are honest."""
    from halo2_aes_tpu_torch.backend.verifier import verify_batch

    return verify_batch(vk, bundle.proofs, [[i] for i in bundle.instances()],
                        multiopen=multiopen)


def xor_keystream(bundle: CtrBundle, data: bytes) -> bytes:
    """CTR encrypt/decrypt: data XOR keystream (public, not proven)."""
    if len(data) > bundle.n_blocks * 16:
        raise ValueError("keystream too short")
    ks = bundle.keystream.reshape(-1)[:len(data)]
    return bytes(np.bitwise_xor(
        np.frombuffer(data, dtype=np.uint8), ks).tobytes())
