"""Matrix caching: save/restore of the preprocessed CSX tables.

Parity with the reference persistence layer (``include/sparsex/internals/
CsxSaveRestore.hpp:76-369``: boost binary serialization of the per-thread
CSX + re-JIT on restore).  Here the archive is a single ``.npz`` holding
every shard's tables plus a JSON metadata record; "re-JIT" is re-tracing —
executors are rebuilt from the tables on restore and XLA recompiles (and
caches) on first use, exactly like the reference regenerates ``spmv_fn``
from the saved ``id_map``.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

from sparsex_jax.csx import CsxMatrix
from sparsex_jax.errors import ErrorCode, seterror
from sparsex_jax.ops.exec import CsxExecutor
from sparsex_jax.parallel.partition import RowPartition
from sparsex_jax.preprocess.encodings import EncType
from sparsex_jax.preprocess.tables import (
    BlockTable, CsxTables, DeltaTable, DiagTable, RunTable,
)

# v2 added per-table DIA occupancy masks, dvalues for symmetric archives
# and the partition/permutation arrays; v1 archives predate those fields
# and are rejected with a clean error instead of a KeyError.  v3 is v2
# under the package's current name; v2 archives read the same way (a
# "layouts" entry that older v2 writers added is ignored).
_MAGIC = "sparsex-csx-v3"
_COMPAT_MAGICS = ("sparsex_tpu-csx-v2",)


def save_csx(mat: CsxMatrix, filename: str,
             permutation: Optional[np.ndarray] = None) -> None:
    """``spx_mat_save`` parity (ref ``src/api/matvec.c:409``)."""
    arrays = {}
    meta = {
        "magic": _MAGIC,
        "nrows": mat.nrows,
        "ncols": mat.ncols,
        "nnz": mat.nnz,
        "symmetric": mat.symmetric,
        "nshards": len(mat.shards),
        "shards": [],
    }
    for i, t in enumerate(mat.shards):
        smeta = {
            "nrows": t.nrows, "ncols": t.ncols, "nnz": t.nnz,
            "row_start": t.row_start,
            "has_delta": t.delta is not None,
            "runs": [{"enc": int(r.enc), "delta": r.delta} for r in t.runs],
            "blocks": [{"enc": int(b.enc)} for b in t.blocks],
            "dias": [{"anti": d.anti, "nnz": d.nnz_count} for d in t.dias],
        }
        meta["shards"].append(smeta)
        if t.delta is not None:
            arrays[f"s{i}_d_rowptr"] = t.delta.rowptr
            arrays[f"s{i}_d_cols"] = t.delta.cols
            arrays[f"s{i}_d_vals"] = t.delta.vals
            arrays[f"s{i}_d_rowids"] = t.delta.row_ids
        for j, r in enumerate(t.runs):
            arrays[f"s{i}_r{j}_rows"] = r.rows
            arrays[f"s{i}_r{j}_cols"] = r.cols
            arrays[f"s{i}_r{j}_sizes"] = r.sizes
            arrays[f"s{i}_r{j}_vals"] = r.vals
        for j, b in enumerate(t.blocks):
            arrays[f"s{i}_b{j}_rows"] = b.rows
            arrays[f"s{i}_b{j}_cols"] = b.cols
            arrays[f"s{i}_b{j}_vals"] = b.vals
        for j, d in enumerate(t.dias):
            arrays[f"s{i}_g{j}_offsets"] = d.offsets
            arrays[f"s{i}_g{j}_vals"] = d.vals
            arrays[f"s{i}_g{j}_mask"] = np.packbits(d.mask, axis=None)
    if mat.symmetric:
        for i, dv in enumerate(getattr(mat, "dvalues", [])):
            arrays[f"s{i}_dvalues"] = dv
    if permutation is not None:
        arrays["permutation"] = np.asarray(permutation)
    if mat.partition is not None:
        meta["partition"] = {
            "row_start": list(mat.partition.row_start),
            "row_end": list(mat.partition.row_end),
            "nnz": list(mat.partition.nnz_per_part),
        }
    arrays["meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    try:
        np.savez_compressed(filename, **arrays)
    except OSError as e:
        seterror(ErrorCode.SPX_ERR_FILE_WRITE, f"cannot write {filename}: {e}")


def restore_csx(filename: str) -> Tuple[CsxMatrix, Optional[np.ndarray]]:
    """``spx_mat_restore`` parity (ref ``src/api/matvec.c:427``)."""
    try:
        # np.savez_compressed appends ".npz" when missing; mirror that on
        # load so save/restore accept the same filename.
        import os
        if not os.path.exists(filename) and os.path.exists(filename + ".npz"):
            filename = filename + ".npz"
        with np.load(filename) as data:
            arrays = {k: data[k] for k in data.files}
    except OSError as e:
        seterror(ErrorCode.SPX_ERR_FILE_READ, f"cannot read {filename}: {e}")
    try:
        meta = json.loads(bytes(arrays["meta"]).decode("utf-8"))
        magic = meta["magic"]
    except Exception:
        seterror(ErrorCode.SPX_ERR_FILE_READ,
                 f"{filename} is not a sparsex_jax CSX archive")
    if magic != _MAGIC and magic not in _COMPAT_MAGICS:
        if magic.endswith("-csx-v1"):
            seterror(ErrorCode.SPX_ERR_FILE_READ,
                     f"{filename} uses archive format '{magic}'; this "
                     f"build reads '{_MAGIC}' — re-save with mat_save")
        seterror(ErrorCode.SPX_ERR_FILE_READ,
                 f"{filename} is not a sparsex_jax CSX archive")

    if meta["symmetric"]:
        from sparsex_jax.symmetric import SymCsxMatrix
        mat = SymCsxMatrix(nrows=meta["nrows"], ncols=meta["ncols"],
                           nnz=meta["nnz"])
        try:
            mat.dvalues = [arrays[f"s{i}_dvalues"]
                           for i in range(meta["nshards"])]
        except KeyError:
            seterror(ErrorCode.SPX_ERR_FILE_READ,
                     f"{filename}: symmetric archive missing dvalues")
    else:
        mat = CsxMatrix(nrows=meta["nrows"], ncols=meta["ncols"],
                        nnz=meta["nnz"], symmetric=meta["symmetric"])
    for i, smeta in enumerate(meta["shards"]):
        delta = None
        if smeta["has_delta"]:
            delta = DeltaTable(
                rowptr=arrays[f"s{i}_d_rowptr"],
                cols=arrays[f"s{i}_d_cols"],
                vals=arrays[f"s{i}_d_vals"],
                row_ids=arrays[f"s{i}_d_rowids"],
            )
        runs = [RunTable(enc=EncType(rm["enc"]), delta=rm["delta"],
                         rows=arrays[f"s{i}_r{j}_rows"],
                         cols=arrays[f"s{i}_r{j}_cols"],
                         sizes=arrays[f"s{i}_r{j}_sizes"],
                         vals=arrays[f"s{i}_r{j}_vals"])
                for j, rm in enumerate(smeta["runs"])]
        blocks = [BlockTable(enc=EncType(bm["enc"]),
                             rows=arrays[f"s{i}_b{j}_rows"],
                             cols=arrays[f"s{i}_b{j}_cols"],
                             vals=arrays[f"s{i}_b{j}_vals"])
                  for j, bm in enumerate(smeta["blocks"])]
        dias = []
        for j, dm in enumerate(smeta.get("dias", [])):
            vals = arrays[f"s{i}_g{j}_vals"]
            mask = np.unpackbits(
                arrays[f"s{i}_g{j}_mask"],
                count=vals.size).reshape(vals.shape).astype(bool)
            dias.append(DiagTable(anti=dm["anti"],
                                  offsets=arrays[f"s{i}_g{j}_offsets"],
                                  vals=vals, mask=mask,
                                  nnz_count=dm["nnz"]))
        tables = CsxTables(nrows=smeta["nrows"], ncols=smeta["ncols"],
                           nnz=smeta["nnz"], row_start=smeta["row_start"],
                           delta=delta, runs=runs, blocks=blocks, dias=dias)
        mat.shards.append(tables)
        mat.executors.append(CsxExecutor(tables))  # re-trace == re-JIT
    if "partition" in meta:
        p = meta["partition"]
        mat.partition = RowPartition(
            nparts=len(p["row_start"]), row_start=p["row_start"],
            row_end=p["row_end"], nnz_per_part=p["nnz"])
    perm = arrays.get("permutation")
    return mat, perm
