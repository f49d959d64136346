"""CombBLAS-style proprietary binary format (paper §6).

Layout: 48-byte header (six int64: magic, version, m, n, nnz, value dtype
code) followed by contiguous int64 rows, int64 cols, and values.
Reads/writes are memory-mapped and chunked across workers. The port's copy
of ``repro.io.binio`` (numpy only, the same ``io.bin_body`` fault site and
the same named errors on malformed input).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..obs import recorder as _obs
from ..robust import faults as _faults

MAGIC = 0x434242494F31      # "CBBIO1"
_DTYPES = {0: np.float64, 1: np.float32, 2: np.int64, 3: np.int32}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_HDR_BYTES = 48             # 6 × int64


@_obs.timed("io.write_bin")
def write_binary(path: str, shape, rows, cols, vals, nwriters: int = 4):
    m, n = shape
    nnz = len(rows)
    vals = np.asarray(vals)
    code = _CODES[vals.dtype]
    header = np.array([MAGIC, 1, m, n, nnz, code], np.int64)
    rows64 = np.asarray(rows, np.int64)
    cols64 = np.asarray(cols, np.int64)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        total = nnz * (16 + vals.itemsize)
        f.truncate(48 + total)
    mm = np.memmap(path, np.uint8, "r+", offset=48)
    r_view = mm[: nnz * 8].view(np.int64)
    c_view = mm[nnz * 8: nnz * 16].view(np.int64)
    v_view = mm[nnz * 16:].view(vals.dtype)

    def put(i):
        s = slice(nnz * i // nwriters, nnz * (i + 1) // nwriters)
        r_view[s] = rows64[s]
        c_view[s] = cols64[s]
        v_view[s] = vals[s]

    with ThreadPoolExecutor(nwriters) as ex:
        list(ex.map(put, range(nwriters)))
    mm.flush()
    _obs.counter_add("io.bytes_written", os.path.getsize(path))
    _faults.corrupt_file("io.bin_body", path)


@_obs.timed("io.read_bin")
def read_binary(path: str, nreaders: int = 4):
    """Read a CBBIO1 file; malformed/truncated input raises ValueError
    naming the file and byte offset — never an IndexError, KeyError, or a
    memmap crash on garbage sizes."""
    fsize = os.path.getsize(path)
    _obs.counter_add("io.bytes_read", fsize)
    if fsize < _HDR_BYTES:
        raise ValueError(f"{path}: truncated header — file is {fsize} bytes, "
                         f"need {_HDR_BYTES} (offset 0)")
    header = np.fromfile(path, np.int64, 6)
    if header[0] != MAGIC:
        raise ValueError(f"{path}: bad magic {int(header[0]):#x} at offset 0 "
                         f"(want {MAGIC:#x})")
    _, _, m, n, nnz, code = (int(x) for x in header)
    if code not in _DTYPES:
        raise ValueError(f"{path}: unknown value dtype code {code} at "
                         f"offset 40")
    if m < 0 or n < 0 or nnz < 0:
        raise ValueError(f"{path}: negative dimension in header "
                         f"(m={m}, n={n}, nnz={nnz})")
    dtype = _DTYPES[code]
    expected = _HDR_BYTES + nnz * (16 + np.dtype(dtype).itemsize)
    if fsize < expected:
        raise ValueError(
            f"{path}: truncated body — header promises {nnz} entries "
            f"({expected} bytes) but file is {fsize} bytes "
            f"(body starts at offset {_HDR_BYTES})")
    mm = np.memmap(path, np.uint8, "r", offset=_HDR_BYTES)
    rows = np.empty(nnz, np.int64)
    cols = np.empty(nnz, np.int64)
    vals = np.empty(nnz, dtype)

    def get(i):
        s = slice(nnz * i // nreaders, nnz * (i + 1) // nreaders)
        rows[s] = mm[: nnz * 8].view(np.int64)[s]
        cols[s] = mm[nnz * 8: nnz * 16].view(np.int64)[s]
        vals[s] = mm[nnz * 16:].view(dtype)[s]

    with ThreadPoolExecutor(nreaders) as ex:
        list(ex.map(get, range(nreaders)))
    return (m, n), rows, cols, vals
