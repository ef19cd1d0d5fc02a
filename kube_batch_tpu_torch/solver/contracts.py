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

from typing import Dict, Optional

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

# NumPy and torch spellings of each contract dtype.
_DTYPE_NAMES = {
    "f32": ("float32", "torch.float32"),
    "i32": ("int32", "torch.int32"),
    "bool": ("bool", "bool_", "torch.bool"),
}


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
