"""Match-expression atom satisfaction: the port of `tpusched/kernels/atoms.py`.

    sat[x, a] = does label set x satisfy atom a

`atom_sat` is kernel K1 (csrc/atoms.cu) on a CUDA tensor and its plain
version, `atom_sat_plain`, on a CPU tensor. The term gathers stay plain
torch here; the tableau kernel (K2) evaluates them per cell itself. With
a leading tenant axis ([B, X, L] labels, [B, A, ...] atom tables) both
give [B, X, A].
"""

from __future__ import annotations

import torch

from tpusched_torch import _build
from tpusched_torch.config import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_IN,
)
from tpusched_torch.kernels import check, per_tenant, stream_of
from tpusched_torch.snapshot import AtomTable


def atom_sat_plain(atoms: AtomTable, label_pairs: torch.Tensor,
                   label_keys: torch.Tensor,
                   label_nums: torch.Tensor | None = None) -> torch.Tensor:
    """[X, A] bool for label arrays of shape [X, L]: the JAX function's
    broadcast [X, L, A, V] compare-reduce. label_nums None skips the
    Gt/Lt branch (pod label sets never face it). A tenant batch goes
    tenant by tenant."""
    if label_pairs.dim() == 3:
        return per_tenant(atom_sat_plain, label_pairs.shape[0], atoms,
                          label_pairs, label_keys, label_nums)
    lp = label_pairs[:, :, None]                     # [X, L, 1]
    lk = label_keys[:, :, None]                      # [X, L, 1]
    pair_hit = lp[:, :, :, None] == atoms.pairs[None, None, :, :]  # [X,L,A,V]
    pair_hit &= (atoms.pairs >= 0)[None, None, :, :]
    any_pair = pair_hit.any(dim=3).any(dim=1)        # [X, A]
    exists = ((lk == atoms.key[None, None, :]) & (lk >= 0)).any(dim=1)
    if label_nums is not None:
        matched = ((lk == atoms.key[None, None, :])
                   & torch.isfinite(label_nums)[:, :, None])
        has_num = matched.any(dim=1)
        val = torch.where(matched, label_nums[:, :, None],
                          torch.zeros((), dtype=label_nums.dtype,
                                      device=label_nums.device)).sum(dim=1)
        gt = has_num & (val > atoms.num[None, :])
        lt = has_num & (val < atoms.num[None, :])
    else:
        gt = torch.zeros_like(exists)
        lt = torch.zeros_like(exists)
    op = atoms.op[None, :].to(torch.int32)
    # jnp.select: the first matching condition wins, default False.
    sat = torch.zeros_like(exists)
    for code, value in reversed(((OP_IN, any_pair), (OP_NOT_IN, ~any_pair),
                                 (OP_EXISTS, exists),
                                 (OP_DOES_NOT_EXIST, ~exists),
                                 (OP_GT, gt), (OP_LT, lt))):
        sat = torch.where(op == code, value, sat)
    return sat & atoms.valid[None, :]


def atom_sat(atoms: AtomTable, label_pairs: torch.Tensor,
             label_keys: torch.Tensor,
             label_nums: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K1 on CUDA tensors, the plain version on CPU tensors."""
    if label_pairs.device.type == "cpu":
        return atom_sat_plain(atoms, label_pairs, label_keys, label_nums)
    lead = label_pairs.shape[:-2]          # () or (B,): the tenant axis
    X, L = label_pairs.shape[-2:]
    A, V = atoms.pairs.shape[-2:]
    dev = label_pairs.device
    check("atom_sat", dev, label_pairs, torch.int32, (*lead, X, L))
    check("atom_sat", dev, label_keys, torch.int32, (*lead, X, L))
    if label_nums is not None:
        check("atom_sat", dev, label_nums, torch.float32, (*lead, X, L))
    check("atom_sat", dev, atoms.key, torch.int32, (*lead, A))
    check("atom_sat", dev, atoms.op, torch.int8, (*lead, A))
    check("atom_sat", dev, atoms.pairs, torch.int32, (*lead, A, V))
    check("atom_sat", dev, atoms.num, torch.float32, (*lead, A))
    check("atom_sat", dev, atoms.valid, torch.bool, (*lead, A))
    out = torch.empty((*lead, X, A), dtype=torch.bool, device=dev)
    if out.numel() == 0:
        return out  # no atoms (or no label sets): nothing to launch
    nums = label_nums.data_ptr() if label_nums is not None else None
    _build.launch(
        "tpusched_atom_sat", label_pairs.data_ptr(), label_keys.data_ptr(),
        nums, lead[0] if lead else 1, X, L, atoms.key.data_ptr(), atoms.op.data_ptr(),
        atoms.pairs.data_ptr(), atoms.num.data_ptr(),
        atoms.valid.data_ptr(), A, V, out.data_ptr(), stream_of(dev))
    atom_sat.launches += 1
    return out


atom_sat.launches = 0


def gather_term_sat(sat_t: torch.Tensor,
                    term_atoms: torch.Tensor) -> torch.Tensor:
    """AND of atom satisfaction over a term's atom list.

    sat_t: [A, X]; term_atoms: [..., AT] int32 atom ids, -1 padded.
    Returns [..., X] bool. Padded slots are the AND identity; a term
    with zero atoms is all-True and must be masked by the caller's
    term-valid flag."""
    gathered = sat_t[term_atoms.clamp(min=0).long()]        # [..., AT, X]
    gathered = gathered | (term_atoms < 0)[..., None]
    return gathered.all(dim=-2)


def gather_selector_match(sat_t: torch.Tensor, sel_atoms: torch.Tensor,
                          subject_valid: torch.Tensor) -> torch.Tensor:
    """Selector match over pod label sets; zero atoms match every valid
    subject (upstream empty label selector)."""
    return gather_term_sat(sat_t, sel_atoms) & subject_valid
