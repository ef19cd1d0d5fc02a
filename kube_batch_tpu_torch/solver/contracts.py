"""Shape and dtype contracts of the solver's input bundles.

A copy of the runtime checks in ``kube_batch_tpu/solver/contracts.py``
(the declaration tables and :func:`validate_packed` /
:func:`validate_solver_inputs`). Symbols: ``T`` tasks, ``N`` nodes,
``R`` resource dims, ``Q`` queues, ``G`` feasibility groups, ``P``
private-row tasks, ``S`` static-score rows, ``C`` candidate classes,
``K`` candidate width. Symbolic dims bind across fields (every ``T``
must agree). Works on NumPy arrays and torch tensors alike.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

# KBT_CHECK_CONTRACTS=1 validates every tensorize and device-cache pack
# (``pack_inputs`` always validates).
CHECK_CONTRACTS_ENV = "KBT_CHECK_CONTRACTS"

SOLVER_INPUT_CONTRACTS = {
    "task_req":        {"shape": ["T", "R"], "dtype": "f32"},
    "task_fit":        {"shape": ["T", "R"], "dtype": "f32"},
    "task_rank":       {"shape": ["T"], "dtype": "i32"},
    "task_job":        {"shape": ["T"], "dtype": "i32"},
    "task_queue":      {"shape": ["T"], "dtype": "i32"},
    "task_valid":      {"shape": ["T"], "dtype": "bool"},
    "task_group":      {"shape": ["T"], "dtype": "i32"},
    "node_feas":       {"shape": ["N"], "dtype": "bool"},
    "group_feas":      {"shape": ["G", "N"], "dtype": "bool"},
    "pair_idx":        {"shape": ["P"], "dtype": "i32"},
    "pair_feas":       {"shape": ["P", "N"], "dtype": "bool"},
    "score_idx":       {"shape": ["S"], "dtype": "i32"},
    "score_rows":      {"shape": ["S", "N"], "dtype": "f32"},
    "node_idle":       {"shape": ["N", "R"], "dtype": "f32"},
    "node_releasing":  {"shape": ["N", "R"], "dtype": "f32"},
    "node_cap":        {"shape": ["N", "R"], "dtype": "f32"},
    "node_task_count": {"shape": ["N"], "dtype": "i32"},
    "node_max_tasks":  {"shape": ["N"], "dtype": "i32"},
    "queue_deserved":  {"shape": ["Q", "R"], "dtype": "f32"},
    "queue_allocated": {"shape": ["Q", "R"], "dtype": "f32"},
    "eps":             {"shape": ["R"], "dtype": "f32"},
    "lr_weight":       {"shape": [], "dtype": "f32"},
    "br_weight":       {"shape": [], "dtype": "f32"},
    "task_cand":       {"shape": ["T"], "dtype": "i32", "optional": True},
    "cand_idx":        {"shape": ["C", "K"], "dtype": "i32",
                        "optional": True},
    "cand_static":     {"shape": ["C", "K"], "dtype": "f32",
                        "optional": True},
    "cand_info":       {"shape": [3, "C"], "dtype": "i32",
                        "optional": True},
}

PACKED_INPUT_CONTRACTS = {
    "task_f32":    {"shape": [2, "T", "R"], "dtype": "f32"},
    "task_i32":    {"shape": [6, "T"], "dtype": "i32"},
    "node_f32":    {"shape": [3, "N", "R"], "dtype": "f32"},
    "node_i32":    {"shape": [3, "N"], "dtype": "i32"},
    "group_feas":  {"shape": ["G", "N"], "dtype": "bool"},
    "pair_idx":    {"shape": ["P"], "dtype": "i32"},
    "pair_feas":   {"shape": ["P", "N"], "dtype": "bool"},
    "score_idx":   {"shape": ["S"], "dtype": "i32"},
    "score_rows":  {"shape": ["S", "N"], "dtype": "f32"},
    "queue_f32":   {"shape": [2, "Q", "R"], "dtype": "f32"},
    "misc":        {"shape": ["R+2"], "dtype": "f32"},
    "cand_idx":    {"shape": ["C", "K"], "dtype": "i32", "optional": True},
    "cand_static": {"shape": ["C", "K"], "dtype": "f32", "optional": True},
    "cand_info":   {"shape": [3, "C"], "dtype": "i32", "optional": True},
}

# -- sharded-solve partition contracts ---------------------------------------
# Which dim of each SolverInputs field the multi-device solvers split
# over the 1-D mesh; fields absent from a table are replicated values
# under that solver. ``solver/spmd.py`` places its shards from these
# tables, and :func:`check_shard_dims` holds every key and dim against
# ``SOLVER_INPUT_CONTRACTS`` (the reference's lint pass over them).
#
# Dense SPMD (spmd._solve_spmd_local): node COLUMNS split, node/queue
# tables and task vectors replicated.
DENSE_SPMD_SHARD_DIMS = {
    "node_feas": 0,
    "group_feas": 1,
    "pair_feas": 1,
    "score_rows": 1,
}
# Sharded SPARSE solve (spmd._solve_sparse_spmd_local): every input
# field is replicated; the task axis splits the DERIVED per-task slab
# expansions ([T, K] candidate ids and keys, [T, K, R] idle gathers)
# inside the shard body.
SPARSE_SHARD_DIMS = {}
# Two-level rack decomposition (spmd two_level=True): the per-rack phase
# gives each shard exclusive WRITE ownership of one N/s node block along
# these fields' node axis (sharding.rack_perm's shard→rack map). The
# values stay replicated (the psum reconcile depends on it); the table
# declares the logical ownership split.
TWO_LEVEL_RACK_DIMS = {
    "node_feas": 0,
    "node_idle": 0,
    "node_releasing": 0,
    "node_cap": 0,
    "node_task_count": 0,
    "node_max_tasks": 0,
}


def check_shard_dims() -> None:
    """Every partition table's keys are declared solver-input fields and
    every split dim is within the field's declared rank, else
    :class:`ContractViolation`."""
    errors = []
    for name, table in (("DENSE_SPMD_SHARD_DIMS", DENSE_SPMD_SHARD_DIMS),
                        ("SPARSE_SHARD_DIMS", SPARSE_SHARD_DIMS),
                        ("TWO_LEVEL_RACK_DIMS", TWO_LEVEL_RACK_DIMS)):
        for field, dim in table.items():
            contract = SOLVER_INPUT_CONTRACTS.get(field)
            if contract is None:
                errors.append(f"{name}: {field} is not a solver input")
            elif not 0 <= dim < len(contract["shape"]):
                errors.append(
                    f"{name}: {field} dim {dim} outside its rank "
                    f"{len(contract['shape'])}"
                )
    if errors:
        raise ContractViolation("; ".join(errors))


# NumPy and torch spellings of each contract dtype.
_DTYPE_NAMES = {
    "f32": ("float32", "torch.float32"),
    "i32": ("int32", "torch.int32"),
    "bool": ("bool", "bool_", "torch.bool"),
}


def contracts_enabled() -> bool:
    return os.environ.get(CHECK_CONTRACTS_ENV, "0") == "1"


class ContractViolation(AssertionError):
    """A produced array disagrees with its declared shape/dtype
    contract (or two fields disagree on a shared symbolic dim)."""


def _check_dim(field: str, i: int, sym, size: int,
               bound: Dict[str, int], errors: list) -> None:
    if isinstance(sym, int):
        if size != sym:
            errors.append(f"{field}: dim {i} is {size}, contract pins {sym}")
        return
    if "+" in sym:
        base, _, off = sym.partition("+")
        if base in bound and size != bound[base] + int(off):
            errors.append(
                f"{field}: dim {i} is {size}, contract {sym} = "
                f"{bound[base] + int(off)} (with {base}={bound[base]})"
            )
        return
    if sym in bound:
        if size != bound[sym]:
            errors.append(
                f"{field}: dim {i} ({sym}) is {size}, but {sym} was "
                f"bound to {bound[sym]} by an earlier field"
            )
    else:
        bound[sym] = size


def _dtype_name(dtype) -> str:
    return getattr(dtype, "name", None) or str(dtype)


def _validate(arrays, table, where: str,
              bound: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    bound = dict(bound or {})
    errors: list = []
    for field, contract in table.items():
        arr = arrays.get(field)
        if arr is None:
            if not contract.get("optional"):
                errors.append(f"{field}: missing (contract is mandatory)")
            continue
        shape = contract["shape"]
        arr_shape = tuple(getattr(arr, "shape", ()))
        if len(arr_shape) != len(shape):
            errors.append(
                f"{field}: ndim {len(arr_shape)} (shape {arr_shape}), "
                f"contract declares {shape}"
            )
            continue
        dtype = getattr(arr, "dtype", None)
        if dtype is not None and (
            _dtype_name(dtype) not in _DTYPE_NAMES[contract["dtype"]]
        ):
            errors.append(
                f"{field}: dtype {dtype}, contract declares "
                f"{contract['dtype']}"
            )
        for i, sym in enumerate(shape):
            _check_dim(field, i, sym, arr_shape[i], bound, errors)
    for field in sorted(set(arrays) - set(table)):
        errors.append(
            f"{field}: produced but not declared in the contract table"
        )
    if errors:
        raise ContractViolation(
            f"solver tensor contract violation(s) at {where}:\n  "
            + "\n  ".join(errors)
        )
    return bound


def validate_packed(arrays: Dict[str, object],
                    where: str = "pack") -> Dict[str, int]:
    """Check a stacked-buffer dict against
    :data:`PACKED_INPUT_CONTRACTS`; returns the symbolic-dim binding."""
    return _validate(arrays, PACKED_INPUT_CONTRACTS, where)


def validate_solver_inputs(inputs, where: str = "inputs") -> Dict[str, int]:
    """Check a ``SolverInputs`` bundle (NumPy or torch) against
    :data:`SOLVER_INPUT_CONTRACTS`."""
    arrays = {
        field: getattr(inputs, field, None)
        for field in SOLVER_INPUT_CONTRACTS
    }
    return _validate(arrays, SOLVER_INPUT_CONTRACTS, where)
