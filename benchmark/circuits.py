"""Circuit kinds a configuration file names under "circuit": how the
program and the reference each build the layout and the witness of a
request.  The program's side imports the port; the reference's side
imports only ``benchmark.reference``."""

from __future__ import annotations

import numpy as np


class Aes128:
    """AES-128 encryption of a batch of blocks under one key (the port's
    ``models/aes128.py``); configuration keys: k, n_sets, n_blocks,
    tagged_ops."""

    @staticmethod
    def _cfg(config):
        return dict(k=config["k"], n_sets=config["n_sets"],
                    n_blocks=config["n_blocks"], tagged_ops=config["tagged_ops"])

    def program_layout(self, config):
        from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

        return compile_circuit(AesConfig(**self._cfg(config)))

    def program_values(self, layout, req, device):
        import torch

        from halo2_aes_tpu_torch.circuit import witness

        key = torch.as_tensor(req.key, device=device)
        pts = torch.as_tensor(req.pts, device=device)
        return witness.assemble_values(layout, witness.build_pool(key, pts))

    def reference_layout(self, config):
        from benchmark.reference.frozen import aes128

        return aes128.compile_circuit(aes128.AesConfig(**self._cfg(config)))

    def reference_values(self, layout, req) -> np.ndarray:
        from benchmark.reference import aes

        pool = aes.pool(req.key, req.pts)
        wm = np.asarray(layout.witness_map)
        return (np.where(wm >= 0, pool[np.maximum(wm, 0)], 0)
                + np.asarray(layout.fixed, dtype=np.int64))


KINDS = {"aes128": Aes128()}
