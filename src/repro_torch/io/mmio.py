"""Parallel Matrix Market I/O (paper §6, ParallelReadMM).

The paper's reader: processor p_i seeks to ``filesize·i/|P|``, fast-forwards
to the next newline, and parses until its end boundary, finishing any line
it started (the next reader skips its leading partial line). Writing: rank 0
emits the header; every rank serializes its local nonzeros to a byte stream
and the streams land at precomputed offsets (the collective MPI-IO pattern).

Here "processors" are reader workers (threads); the byte-range splitting
logic is identical to the MPI-IO version. The port's copy of
``repro.io.mmio`` (numpy only, the same ``io.mm_body`` fault site and the
same named errors on malformed input).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..obs import recorder as _obs
from ..robust import faults as _faults


def read_mm_header(path: str):
    """Parse the MatrixMarket banner + size line.

    Malformed input raises ValueError naming the file and byte offset —
    never an IndexError from a short banner or a bare int() traceback.
    """
    with open(path, "rb") as f:
        banner = f.readline().decode(errors="replace")
        if not banner.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file "
                             f"(banner {banner[:40]!r} at offset 0)")
        toks = banner.strip().split()
        if len(toks) < 5:
            raise ValueError(
                f"{path}: malformed MatrixMarket banner at offset 0 — "
                f"want '%%MatrixMarket matrix coordinate <field> "
                f"<symmetry>', got {banner.strip()!r}")
        if toks[1] != "matrix" or toks[2] != "coordinate":
            raise ValueError(
                f"{path}: unsupported MatrixMarket object/format "
                f"{toks[1]!r}/{toks[2]!r} (only 'matrix coordinate')")
        field, symmetry = toks[3], toks[4]
        off = f.tell()
        line = f.readline().decode(errors="replace")
        while line.startswith("%"):
            off = f.tell()
            line = f.readline().decode(errors="replace")
        try:
            m, n, nnz = (int(t) for t in line.split())
        except ValueError:
            raise ValueError(
                f"{path}: bad size line at offset {off} — want "
                f"'<rows> <cols> <nnz>', got {line.strip()!r}") from None
        if m < 0 or n < 0 or nnz < 0:
            raise ValueError(f"{path}: negative dimension in size line at "
                             f"offset {off}: {line.strip()!r}")
        return dict(field=field, symmetry=symmetry, m=m, n=n, nnz=nnz,
                    body_offset=f.tell())


def _parse_text(text: str, pattern: bool, *, path: str = "?",
                offset: int = 0):
    if not text.strip():
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float64))
    width = 2 if pattern else 3
    toks = text.split()
    try:
        flat = np.array(toks, dtype=np.float64)
    except ValueError:
        raise ValueError(
            f"{path}: non-numeric token in coordinate body near offset "
            f"{offset}") from None
    if len(flat) % width:
        raise ValueError(
            f"{path}: truncated/malformed coordinate body near offset "
            f"{offset} — {len(flat)} tokens is not a multiple of the "
            f"{width}-token entry width")
    d = flat.reshape(-1, width)
    vals = np.ones(len(d), np.float64) if pattern else d[:, 2]
    return (d[:, 0].astype(np.int64) - 1, d[:, 1].astype(np.int64) - 1, vals)


def _read_chunk(path, start, end, body0, pattern):
    """Read complete lines whose start lies in [start, end)."""
    with open(path, "rb") as f:
        f.seek(start)
        if start > body0:
            f.readline()            # partial line owned by the predecessor
        pos = f.tell()
        if pos >= end:
            return _parse_text("", pattern, path=path, offset=pos)
        buf = f.read(end - pos)
        tail = f.readline()         # finish the straddling line
        if tail:
            buf += tail
    buf = _faults.corrupt_bytes("io.mm_body", buf)
    return _parse_text(buf.decode(errors="replace"), pattern,
                       path=path, offset=pos)


@_obs.timed("io.read_mm")
def read_mm_parallel(path: str, nreaders: int = 4):
    """Parallel MatrixMarket read → (shape, rows, cols, vals) int64 global."""
    hdr = read_mm_header(path)
    size = os.path.getsize(path)
    _obs.counter_add("io.bytes_read", size)
    body0 = hdr["body_offset"]
    pattern = hdr["field"] == "pattern"
    bounds = [body0 + (size - body0) * i // nreaders
              for i in range(nreaders + 1)]

    def work(i):
        return _read_chunk(path, bounds[i], bounds[i + 1], body0, pattern)

    if nreaders == 1:
        parts = [work(0)]
    else:
        with ThreadPoolExecutor(nreaders) as ex:
            parts = list(ex.map(work, range(nreaders)))
    rows = np.concatenate([p[0] for p in parts])
    cols = np.concatenate([p[1] for p in parts])
    vals = np.concatenate([p[2] for p in parts])
    # pre-expansion entry count must match the header (symmetric expansion
    # below legitimately adds entries) — a truncated body fails here loudly
    if len(rows) != hdr["nnz"]:
        raise ValueError(
            f"{path}: body holds {len(rows)} entries but the size line at "
            f"offset {body0} promised {hdr['nnz']} — truncated or "
            "corrupted file")
    if hdr["symmetry"] == "symmetric":
        off = rows != cols
        rows, cols, vals = (np.concatenate([rows, cols[off]]),
                            np.concatenate([cols, rows[off]]),
                            np.concatenate([vals, vals[off]]))
    return (hdr["m"], hdr["n"]), rows, cols, vals


@_obs.timed("io.write_mm")
def write_mm_parallel(path: str, shape, rows, cols, vals, nwriters: int = 4,
                      field: str = "real"):
    """Parallel MatrixMarket write (precomputed-offset collective pattern)."""
    m, n = shape
    nnz = len(rows)
    header = (f"%%MatrixMarket matrix coordinate {field} general\n"
              f"{m}\t{n}\t{nnz}\n").encode()
    slices = [slice(nnz * i // nwriters, nnz * (i + 1) // nwriters)
              for i in range(nwriters)]

    def serialize(i):
        s = slices[i]
        if field == "pattern":
            lines = [f"{r + 1}\t{c + 1}\n" for r, c in zip(rows[s], cols[s])]
        else:
            lines = [f"{r + 1}\t{c + 1}\t{v:.10g}\n"
                     for r, c, v in zip(rows[s], cols[s], vals[s])]
        return "".join(lines).encode()

    with ThreadPoolExecutor(nwriters) as ex:
        streams = list(ex.map(serialize, range(nwriters)))
    offsets = [len(header)]
    for st in streams[:-1]:
        offsets.append(offsets[-1] + len(st))
    with open(path, "wb") as f:
        f.write(header)
        f.truncate(offsets[-1] + len(streams[-1]))

    def put(i):
        with open(path, "r+b") as f:
            f.seek(offsets[i])
            f.write(streams[i])

    with ThreadPoolExecutor(nwriters) as ex:
        list(ex.map(put, range(nwriters)))
    _obs.counter_add("io.bytes_written", os.path.getsize(path))
