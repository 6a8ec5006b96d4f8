"""Encoding registry and user-facing encoding sequences.

Parity with the reference encodings layer (``include/sparsex/internals/
Encodings.hpp:35-308``, ``src/internals/Encodings.cpp:32-57,108-138``):

- 21 concrete types — None (delta), Horizontal, Vertical, Diagonal,
  AntiDiagonal, BlockRow1..8, BlockCol1..8 — plus the groups BlockRows,
  BlockCols and All;
- short mnemonics ``none,h,v,d,ad,br1..br8,bc1..bc8,br,bc,all``;
- ``EncodingSequence``: parses user xform strings like ``"h{1,2},br2"`` into
  an ordered list of (type, explicit deltas) pairs.
"""

from __future__ import annotations

import enum
import re
from typing import Dict, List, Tuple

from sparsex_jax.errors import ErrorCode, seterror


class EncType(enum.IntEnum):
    NONE = 0  # delta runs of singletons
    HORIZONTAL = 1
    VERTICAL = 2
    DIAGONAL = 3
    ANTI_DIAGONAL = 4
    BLOCK_ROW_1 = 5
    BLOCK_ROW_2 = 6
    BLOCK_ROW_3 = 7
    BLOCK_ROW_4 = 8
    BLOCK_ROW_5 = 9
    BLOCK_ROW_6 = 10
    BLOCK_ROW_7 = 11
    BLOCK_ROW_8 = 12
    BLOCK_COL_1 = 13
    BLOCK_COL_2 = 14
    BLOCK_COL_3 = 15
    BLOCK_COL_4 = 16
    BLOCK_COL_5 = 17
    BLOCK_COL_6 = 18
    BLOCK_COL_7 = 19
    BLOCK_COL_8 = 20

    @property
    def block_alignment(self) -> int:
        """R for BlockRow_R / C for BlockCol_C, 0 for non-block types
        (``Encoding::GetBlockAlignment`` parity)."""
        if EncType.BLOCK_ROW_1 <= self <= EncType.BLOCK_ROW_8:
            return self - EncType.BLOCK_ROW_1 + 1
        if EncType.BLOCK_COL_1 <= self <= EncType.BLOCK_COL_8:
            return self - EncType.BLOCK_COL_1 + 1
        return 0

    @property
    def is_block(self) -> bool:
        return self.block_alignment > 0

    @property
    def is_block_row(self) -> bool:
        return EncType.BLOCK_ROW_1 <= self <= EncType.BLOCK_ROW_8

    @property
    def is_block_col(self) -> bool:
        return EncType.BLOCK_COL_1 <= self <= EncType.BLOCK_COL_8


SHORT_NAMES: Dict[str, EncType] = {
    "none": EncType.NONE,
    "delta": EncType.NONE,
    "h": EncType.HORIZONTAL,
    "v": EncType.VERTICAL,
    "d": EncType.DIAGONAL,
    "ad": EncType.ANTI_DIAGONAL,
}
for _i in range(1, 9):
    SHORT_NAMES[f"br{_i}"] = EncType(EncType.BLOCK_ROW_1 + _i - 1)
    SHORT_NAMES[f"bc{_i}"] = EncType(EncType.BLOCK_COL_1 + _i - 1)

# Group mnemonics expand to lists of concrete types.  The reference restricts
# mined block dims to 2..8 for groups (BlockRow1/BlockCol1 are the
# one-dimensional blocks, gated by spx.matrix.one_dim_blocks).
GROUPS: Dict[str, List[EncType]] = {
    "br": [EncType(EncType.BLOCK_ROW_1 + i) for i in range(1, 8)],
    "bc": [EncType(EncType.BLOCK_COL_1 + i) for i in range(1, 8)],
}
GROUPS["all"] = ([EncType.HORIZONTAL, EncType.VERTICAL, EncType.DIAGONAL,
                  EncType.ANTI_DIAGONAL] + GROUPS["br"] + GROUPS["bc"])


def expand_types(name: str, one_dim_blocks: bool = False) -> List[EncType]:
    """Expand a single mnemonic (possibly a group) to concrete types."""
    name = name.strip().lower()
    if name in GROUPS:
        types = list(GROUPS[name])
        if one_dim_blocks and name in ("br", "bc", "all"):
            if name in ("br", "all"):
                types.append(EncType.BLOCK_ROW_1)
            if name in ("bc", "all"):
                types.append(EncType.BLOCK_COL_1)
        return types
    if name in SHORT_NAMES:
        return [SHORT_NAMES[name]]
    seterror(ErrorCode.SPX_ERR_ARG_INVALID, f"unknown encoding mnemonic {name!r}")
    return []


_TOKEN_RE = re.compile(r"^\s*([a-z]+[0-9]*)\s*(?:\{([0-9,\s]*)\})?\s*$")


class EncodingSequence:
    """Ordered (type, explicit-deltas) pairs parsed from an xform string.

    ``"h{1,2},br2"`` -> [(HORIZONTAL, [1, 2]), (BLOCK_ROW_2, [])].
    Parity with ``EncodingSequence`` (ref ``Encodings.cpp:108-138``).
    """

    def __init__(self, xform: str, one_dim_blocks: bool = False):
        self.entries: List[Tuple[EncType, List[int]]] = []
        self.explicit = False
        # Split on commas not inside braces.
        tokens = re.split(r",(?![^{]*\})", xform.strip())
        for tok in tokens:
            if not tok.strip():
                continue
            m = _TOKEN_RE.match(tok)
            if not m:
                seterror(ErrorCode.SPX_ERR_ARG_INVALID,
                         f"cannot parse encoding token {tok!r}")
            name, deltas_str = m.group(1), m.group(2)
            deltas: List[int] = []
            if deltas_str is not None:
                self.explicit = True
                deltas = [int(d) for d in deltas_str.split(",") if d.strip()]
            for t in expand_types(name, one_dim_blocks):
                self.entries.append((t, list(deltas)))

    def types(self) -> List[EncType]:
        return [t for t, _ in self.entries]

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)
