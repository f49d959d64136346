"""Label-format reader — ReadGeneralizedTuples (paper §6); the port's own
copy of ``repro.io.labelio``, same relabelling bit for bit.

The MCL label format: no header; each line is ``src dst [weight]`` where
src/dst are *arbitrary string labels* (scattered integers, DNA sequences…).
The paper's two-pass algorithm, reproduced with the same communication
structure ("processors" = workers, the all-to-all = bucket exchange):

  pass 1: every worker hashes its labels into {0..max}; the hash range is
          partitioned into |P| buckets; an all-to-all sends (label, hash) to
          the bucket owner; owners dedup with a local set, compute their
          count, and an exclusive scan over owner counts assigns each label
          a unique consecutive id; owners answer each sender with the new
          ids (the reverse all-to-all).
  pass 2: workers re-read their byte range and relabel streaming.

Returned ids are assigned in hash-bucket order ⇒ the relabeling *is* a
random permutation of the vertex space: the load-balance side effect the
paper highlights (one can use this reader in lieu of ParallelReadMM +
explicit permutation).

Returns (shape, rows, cols, vals, labels) where labels[i] is the original
string of vertex i — the paper's "CombBLAS compliant distributed vector"
mapping new ids back to labels.
"""
from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..obs import recorder as _obs


def _hash_label(label: bytes, space: int = 2**61 - 1) -> int:
    return int.from_bytes(hashlib.blake2b(label, digest_size=8).digest(),
                          "little") % space


def _byte_ranges(path, nworkers):
    size = os.path.getsize(path)
    return [(size * i // nworkers, size * (i + 1) // nworkers)
            for i in range(nworkers)]


def _read_lines(path, start, end):
    with open(path, "rb") as f:
        f.seek(start)
        if start > 0:
            f.readline()
        pos = f.tell()
        if pos >= end:
            return []
        buf = f.read(end - pos)
        tail = f.readline()
        if tail:
            buf += tail
    return [ln for ln in buf.split(b"\n") if ln.strip()]


@_obs.timed("io.read_tuples")
def read_generalized_tuples(path: str, nworkers: int = 4, weighted=None):
    """Two-pass parallel label-format reader. See module docstring."""
    _obs.counter_add("io.bytes_read", os.path.getsize(path))
    ranges = _byte_ranges(path, nworkers)

    # ---------------- pass 1: label discovery -------------------------
    def collect(i):
        labels = set()
        for ln in _read_lines(path, *ranges[i]):
            parts = ln.split()
            labels.add(parts[0])
            labels.add(parts[1])
        return labels

    with ThreadPoolExecutor(nworkers) as ex:
        worker_labels = list(ex.map(collect, range(nworkers)))

    # bucket exchange: hash space partitioned into |P| buckets
    space = 2**61 - 1
    buckets: list[set] = [set() for _ in range(nworkers)]
    for labels in worker_labels:                  # the all-to-all
        for lb in labels:
            h = _hash_label(lb, space)
            buckets[h * nworkers // space].add((h, lb))

    # owners dedup (the set is the dedup) and get id ranges via ex-scan
    counts = [len(b) for b in buckets]
    starts = np.zeros(nworkers + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    label_to_id: dict[bytes, int] = {}
    id_to_label: list[bytes] = [b""] * int(starts[-1])
    for bi, b in enumerate(buckets):
        # sort by hash within bucket -> ids are hash-ordered = pseudorandom
        for off, (h, lb) in enumerate(sorted(b)):
            new_id = int(starts[bi]) + off
            label_to_id[lb] = new_id              # the reverse all-to-all
            id_to_label[new_id] = lb
    nvert = int(starts[-1])

    # ---------------- pass 2: streaming relabel -----------------------
    def relabel(i):
        rs, cs, vs = [], [], []
        for ln in _read_lines(path, *ranges[i]):
            parts = ln.split()
            rs.append(label_to_id[parts[0]])
            cs.append(label_to_id[parts[1]])
            vs.append(float(parts[2]) if len(parts) > 2 else 1.0)
        return (np.asarray(rs, np.int64), np.asarray(cs, np.int64),
                np.asarray(vs, np.float64))

    with ThreadPoolExecutor(nworkers) as ex:
        parts = list(ex.map(relabel, range(nworkers)))
    rows = np.concatenate([p[0] for p in parts]) if parts else \
        np.empty(0, np.int64)
    cols = np.concatenate([p[1] for p in parts])
    vals = np.concatenate([p[2] for p in parts])
    labels = [lb.decode() for lb in id_to_label]
    return (nvert, nvert), rows, cols, vals, labels
