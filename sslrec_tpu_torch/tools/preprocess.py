"""Offline dataset preprocessing (port of ``sslrec_tpu/tools/preprocess.py``;
numpy and scipy only).

``kg`` builds a co-interaction knowledge graph: for each behavior matrix
``train_mat_<behavior>.pkl`` the item × item co-interaction counts ``IᵀI``
are kept where they exceed ``--threshold`` (3 by default), and every kept
pair (i, j) becomes a triplet ``i <behavior's position> j`` in ``kg.txt``
(space-separated, the file KMCLR reads).

``stats`` prints each pickled matrix's shape, nnz and density and each tsv's
row count in a dataset directory.

Usage::

    python -m sslrec_tpu_torch.tools.preprocess kg --dir DIR \\
        --behaviors pv,fav,cart,buy [--threshold 3] [--out kg.txt]
    python -m sslrec_tpu_torch.tools.preprocess stats --dir DIR
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np
import scipy.sparse as sp


def _load_mat(path: str) -> sp.csr_matrix:
    with open(path, "rb") as f:
        return sp.csr_matrix(pickle.load(f))


def build_cooc_kg(mats: list[sp.spmatrix], threshold: int = 3) -> np.ndarray:
    """``[n_triplets, 3]`` int64 (head item, relation = the behavior's
    position, tail item), behavior by behavior, each in ``IᵀI``'s COO order."""
    triples = []
    for rel, m in enumerate(mats):
        b = (sp.csr_matrix(m) != 0).astype(np.int64)
        cooc = (b.T @ b).tocoo()
        keep = cooc.data > threshold
        h, t = cooc.row[keep], cooc.col[keep]
        triples.append(np.stack([h, np.full(h.shape, rel, dtype=np.int64), t], axis=1))
    return np.concatenate(triples, axis=0) if triples else np.zeros((0, 3), np.int64)


def write_kg(out_path: str, triples: np.ndarray) -> None:
    np.savetxt(out_path, triples, fmt="%d", delimiter=" ")


def _cmd_kg(args) -> None:
    behaviors = [b for b in args.behaviors.split(",") if b]
    mats = [_load_mat(os.path.join(args.dir, f"train_mat_{b}.pkl")) for b in behaviors]
    triples = build_cooc_kg(mats, args.threshold)
    out = args.out if os.path.isabs(args.out) else os.path.join(args.dir, args.out)
    write_kg(out, triples)
    for rel, b in enumerate(behaviors):
        print(f"behavior {b!r} (relation {rel}): {int((triples[:, 1] == rel).sum())} triples")
    print(f"wrote {triples.shape[0]} triples -> {out}")


def _cmd_stats(args) -> None:
    for path in sorted(glob.glob(os.path.join(args.dir, "*.pkl"))):
        try:
            m = _load_mat(path)
        except Exception:  # noqa: BLE001 — a pickle that is no matrix (category dicts)
            with open(path, "rb") as f:
                obj = pickle.load(f)
            print(f"{os.path.basename(path)}: {type(obj).__name__}")
            continue
        density = m.nnz / max(1, m.shape[0] * m.shape[1])
        print(f"{os.path.basename(path)}: shape={m.shape} nnz={m.nnz} density={density:.6f}")
    for path in sorted(glob.glob(os.path.join(args.dir, "*.tsv"))):
        with open(path) as f:
            n = sum(1 for _ in f)
        print(f"{os.path.basename(path)}: {n} rows")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="sslrec_tpu_torch.tools.preprocess")
    sub = p.add_subparsers(dest="cmd", required=True)
    kg = sub.add_parser("kg", help="build co-interaction kg.txt")
    kg.add_argument("--dir", required=True)
    kg.add_argument("--behaviors", required=True,
                    help="comma-separated behavior names (relation id = position)")
    kg.add_argument("--threshold", type=int, default=3)
    kg.add_argument("--out", default="kg.txt")
    kg.set_defaults(fn=_cmd_kg)
    st = sub.add_parser("stats", help="print dataset statistics")
    st.add_argument("--dir", required=True)
    st.set_defaults(fn=_cmd_stats)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
