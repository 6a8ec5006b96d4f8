#!/usr/bin/env python
"""The one-shot CSR kernel API and CSR partitioning.

Parity with the reference ``src/examples/csr_example.c``:
``spx_matvec_kernel_csr`` (lazily tunes on first call, then reuses the
tuned matrix) and ``spx_partition_csr`` (nnz-balanced row partition of a
CSR matrix).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import sparsex_jax as spx


def main():
    # a small tridiagonal CSR matrix
    n = 12
    rowptr, colind, values = [0], [], []
    for i in range(n):
        for j in (i - 1, i, i + 1):
            if 0 <= j < n:
                colind.append(j)
                values.append(4.0 if i == j else -1.0)
        rowptr.append(len(colind))
    rowptr = np.array(rowptr)
    colind = np.array(colind)
    values = np.array(values)

    spx.init()
    x = np.arange(1.0, n + 1)
    y = np.ones(n)

    # one-shot: tunes lazily on the first call (ref matvec.c:622-673)
    y = spx.matvec_kernel_csr(rowptr, colind, values, n, n,
                              alpha=2.0, x=x, beta=0.5, y=y)
    print("y =", np.asarray(y))

    # second call reuses the tuned matrix
    y = spx.matvec_kernel_csr(rowptr, colind, values, n, n,
                              alpha=1.0, x=x, beta=0.0, y=y)
    print("y =", np.asarray(y))

    # nnz-balanced partition of the CSR rows (ref matvec.c:689-737)
    parts = spx.partition_csr(rowptr, n, 4)
    for i in range(parts.parts.nparts):
        s, e = parts.parts.bounds(i)
        print(f"partition {i}: rows [{s}, {e})  "
              f"nnz={parts.parts.nnz_per_part[i]}")


if __name__ == "__main__":
    main()
