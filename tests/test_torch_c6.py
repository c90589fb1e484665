"""ROADMAP C6's tranche rule: with `preemption=True` and a pod bucket
over twice the tranche width (2 x 1 024), JAX's `_solve_rounds_nosig`
skips the full-width round 1 and caps each tranche at 2 rounds
(`tpusched/kernels/assign.py:1752`, `:1784`). The port's main rounds
follow the same rule, so on a config-5 snapshot whose pod bucket is
4 096 they place, key and count rounds exactly as JAX's do; `used`
is held to rounding, as C6 holds it (JAX adds each node's commits as
segment totals of an f32 cumsum whose order XLA picks; the port adds
them one at a time in rank order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched import synth as jsynth
from tpusched.config import EngineConfig as JConfig
from tpusched.engine import _sat_tables as jsat
from tpusched.kernels import assign as jassign
from tpusched_torch.config import EngineConfig
from tpusched_torch.engine import _sat_tables as tsat
from tpusched_torch.kernels import assign as tassign
from tpusched_torch.snapshot import snapshot_from_numpy


def _main_rounds(P: int, N: int, seed: int, **cfg):
    """Both packages' `_solve_rounds_nosig` on config5_preemption(rng(seed),
    P, N): (port's (used, assigned, chosen, round_of, rounds), JAX's)."""
    jsnap = jax.device_put(jsynth.config5_preemption(
        np.random.default_rng(seed), P, N)[0])
    tsnap = snapshot_from_numpy(jax.device_get(jsnap))
    jcfg, tcfg = JConfig(**cfg), EngineConfig(**cfg)
    Pb = int(jsnap.pods.valid.shape[0])
    Nb = int(jsnap.nodes.valid.shape[0])
    max_rounds = 2 * Pb + 8
    jst = jassign.precompute_static(jcfg, jsnap, *jsat(jsnap))
    jorder = jassign.pop_order(jcfg, jsnap)
    jrank = jnp.zeros(Pb, jnp.int32).at[jorder].set(
        jnp.arange(Pb, dtype=jnp.int32))
    want = jassign._solve_rounds_nosig(jcfg, jsnap, jst, jrank, jorder,
                                       max_rounds,
                                       jassign._fallback_depth(Nb))
    tst = tassign.precompute_static(tcfg, tsnap, *tsat(tsnap))
    torder = tassign.pop_order(tcfg, tsnap)
    trank = torch.zeros(Pb, dtype=torch.int32)
    trank[torder] = torch.arange(Pb, dtype=torch.int32)
    got = tassign._solve_rounds_nosig(tcfg, tsnap, tst, trank, torder,
                                      max_rounds,
                                      tassign._fallback_depth(Nb))
    return got, want, Pb


@pytest.mark.parametrize("max_rounds", [0, 3])
def test_preemption_tranche_rule_equals_jax(max_rounds):
    """Pod bucket 4 096, preemption on: no full-width round 1, tranches
    capped at 2 rounds (under the max_rounds clamp when it is set):
    assignment, round_of (the commit key) and the round count equal to
    JAX's, `used` within rtol 1e-5."""
    got, want, Pb = _main_rounds(3100, 64, 45, mode="fast", preemption=True,
                                 max_rounds=max_rounds)
    assert Pb == 4096
    used, asg, chosen, round_of, rounds = got
    jused, jasg, jchosen, jround_of, jrounds = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(asg.numpy(), jasg)
    np.testing.assert_array_equal(round_of.numpy(), jround_of)
    assert int(rounds) == int(jrounds)
    np.testing.assert_allclose(used.numpy(), jused, rtol=1e-5)
    placed = asg.numpy() >= 0
    # Scores of the placed pods at JAX's CPU parity tolerances (C1).
    np.testing.assert_allclose(chosen.numpy()[placed], jchosen[placed],
                               rtol=1e-4, atol=1e-3)
    assert placed.any() and (~placed[:3100]).any()
