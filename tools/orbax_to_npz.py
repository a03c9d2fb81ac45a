#!/usr/bin/env python3
"""Convert a JAX orbax checkpoint into the path-encoded .npz that the
PyTorch port reads.

    python tools/orbax_to_npz.py CKPT_DIR OUT.npz

CKPT_DIR is a ``gloc3d_tpu`` ``Trainer.save_checkpoint`` directory
(``<workdir>/ckpt_<tag>``: the TrainState's params, batch_stats, optimizer
state and step) or an orbax directory of model variables (params and
batch_stats), the layout the JAX CLI's ``--checkpoint`` restores. OUT.npz
holds every array of ``params`` and ``batch_stats`` under its tree path
joined by ``/`` (``params/encoder/...``, ``batch_stats/...``): the layout
``gloc3d_tpu_torch/convert.py::restore_params`` and the port's CLI
``--checkpoint`` read, for any encoder. The optimizer state and the step
are left out (the port's trainer starts its own). Runs where the JAX
package runs (it needs jax and orbax); the port itself reads no orbax
directory.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Mapping

import numpy as np


def flatten(tree: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    """``{"a": {"b": x}}`` under ``prefix`` → ``{"prefix/a/b": x}``."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(value, Mapping):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def convert(ckpt_dir: str, out_path: str) -> Dict[str, np.ndarray]:
    """Restore ``ckpt_dir`` with orbax and write its params and
    batch_stats to ``out_path``; returns the arrays written."""
    import orbax.checkpoint as ocp

    tree = ocp.StandardCheckpointer().restore(os.path.abspath(ckpt_dir))
    if "params" not in tree:
        raise ValueError(f"{ckpt_dir}: no 'params' in the checkpoint "
                         f"(keys {sorted(tree)})")
    arrays = flatten(tree["params"], "params")
    arrays.update(flatten(tree.get("batch_stats") or {}, "batch_stats"))
    np.savez(out_path, **arrays)
    return arrays


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt_dir", help="orbax checkpoint directory")
    p.add_argument("out", help="the .npz to write")
    args = p.parse_args(argv)
    arrays = convert(args.ckpt_dir, args.out)
    print(f"{args.out}: {len(arrays)} arrays "
          f"({sum(a.size for a in arrays.values())} values)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
