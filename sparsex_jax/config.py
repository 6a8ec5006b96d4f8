"""Runtime configuration.

Parity with the reference ``RtConfig`` singleton property map
(``include/sparsex/internals/Runtime.hpp:49-157``, defaults at
``src/internals/Runtime.cpp:37-63``, mnemonics at ``:65-95``, env overrides at
``:97-149``): the same ``spx.rt.*`` / ``spx.preproc.*`` / ``spx.matrix.*``
mnemonic strings, the same defaults, and the same environment variables
(``NUM_THREADS``, ``CPU_AFFINITY``, ``XFORM_CONF``, ``SAMPLING``, ``SAMPLES``,
``SAMPLING_PORTION``, ``WINDOW_SIZE``, ``SYMMETRIC``).

Additions of this JAX build live under ``spx.jax.*``: value dtype, index
dtype and the device mesh axis used by the sharded executor (the
reference's ``nr_threads``/``cpu_affinity`` become the number of row shards
/ device assignment on a mesh).
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from sparsex_jax.errors import ErrorCode, seterror
from sparsex_jax.logger import LoggingHandler, Level, log_warning


_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def _parse_bool(s: str) -> bool:
    ls = str(s).strip().lower()
    if ls in _TRUE:
        return True
    if ls in _FALSE:
        return False
    raise ValueError(f"not a boolean: {s!r}")


# Validation (parity with RtConfig::CheckProperties, Runtime.hpp:225-231).
_VALIDATORS: Dict[str, Callable[[str], object]] = {
    "spx.rt.nr_threads": lambda s: max(1, int(s)),
    "spx.rt.cpu_affinity": lambda s: [int(t) for t in str(s).split(",") if t != ""],
    "spx.preproc.heuristic": lambda s: {"ratio": "ratio", "cost": "cost",
                                        "device": "device"}[str(s)],
    "spx.preproc.xform": str,
    "spx.preproc.sampling": lambda s: {"none": "none", "portion": "portion",
                                       "window": "window"}[str(s)],
    "spx.preproc.sampling.nr_samples": lambda s: max(1, int(s)),
    "spx.preproc.sampling.portion": float,
    "spx.preproc.sampling.window_size": lambda s: max(0, int(s)),
    "spx.matrix.symmetric": _parse_bool,
    "spx.matrix.split_blocks": _parse_bool,
    "spx.matrix.one_dim_blocks": _parse_bool,
    "spx.matrix.full_colind": _parse_bool,
    "spx.matrix.min_unit_size": lambda s: max(2, int(s)),
    "spx.matrix.max_unit_size": lambda s: max(2, int(s)),
    "spx.matrix.min_coverage": float,
    "spx.jax.value_dtype": lambda s: {"float32": "float32", "float64": "float64",
                                      "bfloat16": "bfloat16"}[str(s)],
    "spx.jax.index_dtype": lambda s: {"int32": "int32", "int64": "int64"}[str(s)],
    "spx.jax.mesh_axis": str,
    "spx.jax.dia_min_fill": float,
    "spx.jax.x_mode": lambda s: {"auto": "auto", "replicated": "replicated",
                                 "halo": "halo"}[str(s)],
    "spx.jax.host_malloc_tune": lambda s: {"true": True, "false": False}[str(s)],
    "spx.jax.sym_full": lambda s: {"auto": "auto", "on": "on",
                                   "off": "off"}[str(s)],
    "spx.log.file": str,
    "spx.log.level": lambda s: {"error": "error", "warning": "warning",
                                "info": "info", "verbose": "verbose",
                                "debug": "debug", "none": "none"}[str(s)],
}


def _default_properties() -> Dict[str, str]:
    """Defaults per reference ``Runtime.cpp:37-63``.

    The reference flips heuristic (cost vs ratio) and full_colind on
    SPX_USE_NUMA; the device analogue of NUMA-interleaved placement is
    per-shard device-memory residency, which is always on, so we take the
    NUMA defaults.
    """
    return {
        "spx.rt.nr_threads": "1",
        "spx.rt.cpu_affinity": "0",
        "spx.preproc.heuristic": "device",
        "spx.preproc.xform": "all",
        "spx.preproc.sampling": "portion",
        "spx.preproc.sampling.nr_samples": "48",
        "spx.preproc.sampling.portion": "0.01",
        "spx.preproc.sampling.window_size": "0",
        "spx.matrix.symmetric": "false",
        "spx.matrix.split_blocks": "true",
        "spx.matrix.one_dim_blocks": "false",
        "spx.matrix.full_colind": "true",
        "spx.matrix.min_unit_size": "4",
        "spx.matrix.max_unit_size": "255",
        "spx.matrix.min_coverage": "0.1",
        "spx.jax.value_dtype": "float64",
        "spx.jax.index_dtype": "int32",
        "spx.jax.mesh_axis": "shards",
        "spx.jax.dia_min_fill": "0.01",
        "spx.jax.x_mode": "auto",
        "spx.jax.sym_full": "auto",
        "spx.jax.host_malloc_tune": "true",
        "spx.log.file": "",
        "spx.log.level": "warning",
    }


class Config:
    """Process-wide configuration singleton (RtConfig parity)."""

    _instance: Optional["Config"] = None
    _lock = threading.Lock()

    def __init__(self):
        self._props: Dict[str, str] = _default_properties()

    @classmethod
    def instance(cls) -> "Config":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls) -> "Config":
        with cls._lock:
            cls._instance = cls()
            return cls._instance

    # -- raw string property access --------------------------------------
    def set(self, key: str, value: str) -> None:
        if key not in self._props:
            seterror(ErrorCode.SPX_ERR_ARG_INVALID, f"unknown option {key!r}")
        try:
            _VALIDATORS[key](value)
        except Exception:
            seterror(ErrorCode.SPX_ERR_ARG_INVALID,
                     f"invalid value {value!r} for option {key!r}")
        self._props[key] = str(value)
        if key == "spx.log.level":
            self._apply_log_level()

    def get(self, key: str) -> str:
        if key not in self._props:
            seterror(ErrorCode.SPX_ERR_ARG_INVALID, f"unknown option {key!r}")
        return self._props[key]

    def _typed(self, key: str):
        return _VALIDATORS[key](self._props[key])

    # -- typed views used across the library ------------------------------
    @property
    def nr_threads(self) -> int:
        return self._typed("spx.rt.nr_threads")

    @property
    def cpu_affinity(self) -> List[int]:
        return self._typed("spx.rt.cpu_affinity")

    @property
    def heuristic(self) -> str:
        return self._typed("spx.preproc.heuristic")

    @property
    def xform(self) -> str:
        return self._typed("spx.preproc.xform")

    @property
    def sampling(self) -> str:
        return self._typed("spx.preproc.sampling")

    @property
    def nr_samples(self) -> int:
        return self._typed("spx.preproc.sampling.nr_samples")

    @property
    def sampling_portion(self) -> float:
        return self._typed("spx.preproc.sampling.portion")

    @property
    def window_size(self) -> int:
        return self._typed("spx.preproc.sampling.window_size")

    @property
    def symmetric(self) -> bool:
        return self._typed("spx.matrix.symmetric")

    @property
    def split_blocks(self) -> bool:
        return self._typed("spx.matrix.split_blocks")

    @property
    def one_dim_blocks(self) -> bool:
        return self._typed("spx.matrix.one_dim_blocks")

    @property
    def full_colind(self) -> bool:
        return self._typed("spx.matrix.full_colind")

    @property
    def min_unit_size(self) -> int:
        return self._typed("spx.matrix.min_unit_size")

    @property
    def max_unit_size(self) -> int:
        return self._typed("spx.matrix.max_unit_size")

    @property
    def min_coverage(self) -> float:
        return self._typed("spx.matrix.min_coverage")

    @property
    def value_dtype(self) -> np.dtype:
        return np.dtype(self._typed("spx.jax.value_dtype"))

    @property
    def index_dtype(self) -> np.dtype:
        return np.dtype(self._typed("spx.jax.index_dtype"))

    @property
    def mesh_axis(self) -> str:
        return self._typed("spx.jax.mesh_axis")

    @property
    def dia_min_fill(self) -> float:
        return self._typed("spx.jax.dia_min_fill")

    @property
    def x_mode(self) -> str:
        return self._typed("spx.jax.x_mode")

    @property
    def sym_full(self) -> str:
        """Symmetric full-expansion executor: "on" runs the mirrored full
        tables (``symmetric.mirror_full_tables``); "auto" and "off" keep
        the per-shard lower-triangle kernels with the transposed
        z-scatter."""
        return self._typed("spx.jax.sym_full")

    def _apply_log_level(self) -> None:
        handler = LoggingHandler.instance()
        level = self._typed("spx.log.level")
        handler.disable_all()
        if level == "none":
            return
        order = ["error", "warning", "info", "verbose", "debug"]
        for i, name in enumerate(order[: order.index(level) + 1]):
            handler.level_to_console(Level(i))

    # -- env overrides (parity with RtConfig::LoadFromEnv) ----------------
    def load_from_env(self, env: Optional[Dict[str, str]] = None) -> "Config":
        env = dict(os.environ) if env is None else env

        def take(var: str, key: str) -> None:
            val = env.get(var)
            if val is not None:
                try:
                    self.set(key, val)
                except Exception:
                    log_warning("ignoring invalid env %s=%r", var, val)

        take("SYMMETRIC", "spx.matrix.symmetric")
        take("NUM_THREADS", "spx.rt.nr_threads")
        take("CPU_AFFINITY", "spx.rt.cpu_affinity")
        take("XFORM_CONF", "spx.preproc.xform")
        take("WINDOW_SIZE", "spx.preproc.sampling.window_size")
        take("SAMPLES", "spx.preproc.sampling.nr_samples")
        take("SAMPLING_PORTION", "spx.preproc.sampling.portion")
        take("SAMPLING", "spx.preproc.sampling")
        if env.get("WINDOW_SIZE") is not None or env.get("SAMPLES") is not None:
            if env.get("SAMPLING") is None and env.get("WINDOW_SIZE") is not None:
                self.set("spx.preproc.sampling", "window")
        return self


# -- module-level convenience (spx_option_set / spx_options_set_from_env) ---
def option_set(key: str, value: str) -> None:
    """Set a runtime option by mnemonic (``spx_option_set`` parity,
    ref ``src/api/matvec.c:753-761``)."""
    Config.instance().set(key, value)


def option_get(key: str) -> str:
    return Config.instance().get(key)


def options_set_from_env() -> None:
    """Load options from environment variables
    (``spx_options_set_from_env`` parity, ref ``src/internals/Runtime.cpp:97-149``)."""
    Config.instance().load_from_env()
