"""PodTopologySpread + InterPodAffinity: the port of
`tpusched/kernels/pairwise.py`.

Pairwise constraints work per SIGNATURE, not per pod: the builder
interns every distinct (topology key, namespace scope, pod-label
selector) into the SigTable, and the solve paths keep a PairState of
three arrays:

    counts[s, d]  = member pods matching signature s in domain d of its
                    topology key (spread counts, affinity presence)
    anti[s, d]    = members HOLDING a required anti-affinity term with
                    signature s in domain d (symmetric anti-affinity)
    match_tot[s]  = members matching s anywhere, key-less nodes included
                    (the "no pod matches the selector" special case)

Members are [running | pending]; a pending pod's column counts once it
commits. Every count is a small integer held in f32 (exact below 2**24).

Kernels (CUDA on CUDA tensors, the `*_plain` version on CPU tensors):
  K9  `sig_match`       [S, M+P] selector and namespace match (csrc/pairwise.cu)
  K10 `pair_counts`     the PairState from scratch: running members, plus
                        pending pods at an assignment when one is given
  K11 `pairwise_batch`  every pod's [N] spread/inter-pod feasibility and
                        normalised spread and inter-pod scores against one
                        state (ScoreBatch and the fast rounds; with
                        `with_ia_ok` also the inter-pod verdict alone, the
                        fast rounds' spread-relaxed feasibility)
  K10 `pair_commit`     add (sign +1) or take back (sign -1) committed
                        pods' contributions: the fast rounds' commits and
                        the validator's reverts
  K14 `ia_ok_at_choice` each pod's required inter-pod and symmetric
                        anti-affinity verdict at its chosen node, its own
                        contribution excluded (the fast validator)
  K25 `ring_hop`        one hop of the count ring (ring.py): a signature
                        block's matches in a member block, counted by
                        domain into the block's [sblk, N] counts
                        (csrc/ring.cu)
The parity scan's per-pod `pairwise_row` and `pair_state_add_pod` run
inside K4's pairwise variant (`kernels/assign.parity_scan_pair`); their
plain versions here drive the plain scan.

A tenant batch (tenants.solve_many) carries a leading [B] axis on every
table here: the member tables [B, S, M+P], the domains and the
PairState [B, S, N] (match_tot [B, S]). Each kernel then launches once
for all tenants, each CTA or thread on its own tenant's rows; each plain
version goes tenant by tenant (`kernels.per_tenant`).
"""

from __future__ import annotations

import dataclasses

import torch

from tpusched_torch import _build
from tpusched_torch.config import DO_NOT_SCHEDULE
from tpusched_torch.kernels import check, per_tenant, ptrs, stream_of
from tpusched_torch.kernels import score as kscore
from tpusched_torch.kernels.atoms import gather_term_sat
from tpusched_torch.snapshot import (
    ClusterSnapshot,
    PodArrays,
    RunningPodArrays,
    SigTable,
    _Tree,
)

# Spread constraints per pod that K4's pairwise variant and K11 take
# (their per-constraint minima live in shared memory).
MAX_C = 16


@dataclasses.dataclass
class PairState(_Tree):
    counts: torch.Tensor     # [S, N] f32 selector-match counts per domain
    anti: torch.Tensor       # [S, N] f32 required-anti-term holders per domain
    match_tot: torch.Tensor  # [S] f32 selector-match counts over all members


def merge_members(run_arr: torch.Tensor, pod_arr: torch.Tensor,
                  lead: int = 0) -> torch.Tensor:
    """[M+P, ...]: running rows, then pending rows (one device, no
    mesh); [B, M+P, ...] for a tenant batch (lead=1)."""
    return torch.cat([run_arr, pod_arr], dim=lead)


def member_ns(snap: ClusterSnapshot) -> torch.Tensor:
    """[M+P] int32 (per tenant [B, M+P]): each member's namespace."""
    return merge_members(snap.running.namespace, snap.pods.namespace,
                         snap.pods.valid.dim() - 1)


def member_label_sat_t(snap: ClusterSnapshot, sat_fn) -> torch.Tensor:
    """[A, M+P] atom satisfaction over member pod labels (K1 through
    `sat_fn`; [B, A, M+P] for a tenant batch); labels never change
    during a solve."""
    lead = snap.pods.valid.dim() - 1
    lp = merge_members(snap.running.label_pairs, snap.pods.label_pairs, lead)
    lk = merge_members(snap.running.label_keys, snap.pods.label_keys, lead)
    return sat_fn(snap.atoms, lp, lk, None).transpose(-2, -1).contiguous()


def ns_scope_ok(sigs_ns: torch.Tensor, sigs_ns_all: torch.Tensor,
                member_ns: torch.Tensor) -> torch.Tensor:
    """[S, X] bool: the member's namespace is in each signature's scope
    (its explicit id list, or all namespaces). Padding ids compare like
    any other id, as in the JAX function."""
    S, X = sigs_ns.shape[0], member_ns.shape[0]
    if sigs_ns.shape[1]:
        ok = (sigs_ns[:, :, None] == member_ns[None, None, :]).any(dim=1)
        return ok | sigs_ns_all[:, None]
    return sigs_ns_all[:, None].expand(S, X)


# -- K9: signature x member match ---------------------------------------------


def sig_match_plain(member_sat_t: torch.Tensor, sigs: SigTable,
                    member_ns: torch.Tensor) -> torch.Tensor:
    """[S, X] bool: member x matches signature s — every selector atom
    satisfied (a selector without atoms matches everyone), namespace in
    scope, signature slot live. A tenant batch goes tenant by tenant."""
    if member_ns.dim() == 2:
        return per_tenant(sig_match_plain, member_ns.shape[0], member_sat_t,
                          sigs, member_ns)
    if member_sat_t.shape[0]:
        match = gather_term_sat(member_sat_t, sigs.atoms)
    else:  # no atoms at all: only atom-less selectors, which match all
        match = (sigs.atoms < 0).all(dim=1)[:, None].expand(
            -1, member_ns.shape[0])
    ns_ok = ns_scope_ok(sigs.ns, sigs.ns_all, member_ns)
    return match & ns_ok & sigs.valid[:, None]


def sig_match(member_sat_t: torch.Tensor, sigs: SigTable,
              member_ns: torch.Tensor) -> torch.Tensor:
    """Kernel K9 on CUDA tensors, the plain version on CPU tensors."""
    dev = member_ns.device
    if dev.type == "cpu":
        return sig_match_plain(member_sat_t, sigs, member_ns)
    lead = member_ns.shape[:-1]            # () or (B,): the tenant axis
    A, X = member_sat_t.shape[-2:]
    S, AT = sigs.atoms.shape[-2:]
    NS = sigs.ns.shape[-1]
    k = "sig_match"
    check(k, dev, member_sat_t, torch.bool, (*lead, A, X))
    check(k, dev, sigs.atoms, torch.int32, (*lead, S, AT))
    check(k, dev, sigs.ns, torch.int32, (*lead, S, NS))
    check(k, dev, sigs.ns_all, torch.bool, (*lead, S))
    check(k, dev, sigs.valid, torch.bool, (*lead, S))
    check(k, dev, member_ns, torch.int32, (*lead, X))
    out = torch.empty((*lead, S, X), dtype=torch.bool, device=dev)
    if out.numel() == 0:
        return out
    _build.launch("tpusched_sig_match", lead[0] if lead else 1, A, S, X,
                  AT, NS,
                  *(t.data_ptr() for t in (member_sat_t, sigs.atoms, sigs.ns,
                                           sigs.ns_all, sigs.valid,
                                           member_ns, out)),
                  stream_of(dev))
    sig_match.launches += 1
    return out


sig_match.launches = 0


def key_domains(dom: torch.Tensor, key: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
    """[S, N] int32: node n's domain id (dom [N, TK]) under key[s]; -1
    where the node lacks the key or live[s] is False. A tenant batch
    gives [B, S, N]."""
    lead = key.shape[:-1]
    S, N = key.shape[-1], dom.shape[-2]
    if dom.shape[-1]:
        k = key.clamp(min=0).long()[..., None, :].expand(*lead, N, S)
        dom_s = dom.gather(-1, k).transpose(-2, -1)
    else:
        dom_s = torch.full((*lead, S, N), -1, dtype=torch.int32,
                           device=dom.device)
    return torch.where(live[..., None], dom_s,
                       torch.full((), -1, dtype=torch.int32,
                                  device=dom.device)).contiguous()


def sig_domains(snap: ClusterSnapshot) -> torch.Tensor:
    """[S, N] int32: node n's domain id under signature s's topology key;
    -1 where the node lacks the key or the signature slot is padding. A
    tenant batch gives [B, S, N]."""
    return key_domains(snap.nodes.domain, snap.sigs.key, snap.sigs.valid)


def member_domains(dom_s: torch.Tensor, node: torch.Tensor,
                   live: torch.Tensor) -> torch.Tensor:
    """[S, X] int32: member x's domain under signature s's key (that of
    its node), -1 where live[x] is False."""
    return torch.where(live[None, :], dom_s[:, node.clamp(min=0).long()],
                       torch.full((), -1, dtype=torch.int32,
                                  device=dom_s.device))


def add_counts(counts: torch.Tensor, on: torch.Tensor,
               mdom: torch.Tensor) -> torch.Tensor:
    """counts[s, mdom[s, x]] += 1 where on[s, x] and mdom[s, x] >= 0 (in
    place; returned). The adds are 0/1 in f32, exact in any order below
    2**24."""
    rows = torch.arange(mdom.shape[0], device=mdom.device)[:, None]
    return counts.index_put_(
        (rows.expand_as(mdom), mdom.clamp(min=0).long()),
        (on & (mdom >= 0)).to(torch.float32), accumulate=True)


def pod_anti_holds(pods: PodArrays) -> torch.Tensor:
    """[P, IT] bool: pod holds a live required anti term in slot t."""
    return pods.ia_valid & pods.ia_anti & pods.ia_required


# -- K10: the pair state from scratch ---------------------------------------


def pair_counts_plain(sig_match: torch.Tensor, dom_s: torch.Tensor,
                      running: RunningPodArrays, pods: PodArrays,
                      assigned: torch.Tensor | None = None,
                      counts: torch.Tensor | None = None) -> PairState:
    """The PairState of the running members plus, when `assigned` is
    given, every pending pod p with assigned[p] >= 0 placed there (JAX
    pair_state_init, and pair_state_seed at that assignment). `counts`
    given (the ring's, JAX pair_state_init(counts=)): the state carries
    them and they are not counted here. The scatter-adds add 0/1 in f32,
    exact in any order. A tenant batch goes tenant by tenant."""
    if dom_s.dim() == 3:
        return per_tenant(pair_counts_plain, dom_s.shape[0], sig_match,
                          dom_s, running, pods, assigned, counts)
    S, N = dom_s.shape
    M, P = running.valid.shape[0], pods.valid.shape[0]
    dev = dom_s.device
    if assigned is None:
        assigned = torch.full((P,), -1, dtype=torch.int32, device=dev)
    valid = merge_members(running.valid, assigned >= 0)
    if counts is None:
        mdom = member_domains(
            dom_s, merge_members(running.node_idx, assigned), valid)
        counts = add_counts(
            torch.zeros((S, N), dtype=torch.float32, device=dev),
            sig_match & valid[None, :], mdom)
    match_tot = (sig_match & valid[None, :]).to(torch.float32).sum(dim=1)
    anti = torch.zeros((S, N), dtype=torch.float32, device=dev)
    asig = running.anti_sig                                  # [M, J]
    if asig.shape[1] and S:
        rnode = running.node_idx.long()
        sclip = asig.clamp(min=0).long()
        dom_m = dom_s[sclip, rnode.clamp(min=0)[:, None]]    # [M, J]
        ok = ((asig >= 0) & (rnode >= 0)[:, None] & running.valid[:, None]
              & (dom_m >= 0))
        anti.index_put_((sclip, dom_m.clamp(min=0).long()),
                        ok.to(torch.float32), accumulate=True)
    holds = pod_anti_holds(pods)
    pnode = assigned.long()
    for t in range(pods.ia_key.shape[1] if S else 0):
        s = pods.ia_sig[:, t].clamp(min=0).long()
        dom_p = dom_s[s, pnode.clamp(min=0)]
        on = holds[:, t] & (pnode >= 0) & (dom_p >= 0)
        anti.index_put_((s, dom_p.clamp(min=0).long()),
                        on.to(torch.float32), accumulate=True)
    return PairState(counts=counts, anti=anti, match_tot=match_tot)


def pair_counts(sig_match: torch.Tensor, dom_s: torch.Tensor,
                running: RunningPodArrays, pods: PodArrays,
                assigned: torch.Tensor | None = None,
                counts: torch.Tensor | None = None) -> PairState:
    """Kernel K10 on CUDA tensors, the plain version on CPU tensors.
    `counts` given (the ring's): the kernel skips its count scatter and
    the state carries these."""
    dev = dom_s.device
    if dev.type == "cpu":
        return pair_counts_plain(sig_match, dom_s, running, pods, assigned,
                                 counts)
    lead = dom_s.shape[:-2]                # () or (B,): the tenant axis
    S, N = dom_s.shape[-2:]
    M, P = running.valid.shape[-1], pods.valid.shape[-1]
    J, IT = running.anti_sig.shape[-1], pods.ia_sig.shape[-1]
    k = "pair_counts"
    check(k, dev, sig_match, torch.bool, (*lead, S, M + P))
    check(k, dev, dom_s, torch.int32, (*lead, S, N))
    check(k, dev, running.node_idx, torch.int32, (*lead, M))
    check(k, dev, running.valid, torch.bool, (*lead, M))
    check(k, dev, running.anti_sig, torch.int32, (*lead, M, J))
    _check_ia_terms(k, dev, pods, (*lead, P), IT)
    if assigned is not None:
        check(k, dev, assigned, torch.int32, (*lead, P))
    st = _zero_state(lead, S, N, dev)
    if counts is not None:
        check(k, dev, counts, torch.float32, (*lead, S, N))
        st.counts = counts
    if S * (M + P) == 0 or dom_s.numel() == 0:
        return st
    _build.launch(
        "tpusched_pair_counts", lead[0] if lead else 1, S, N, M, P, J, IT,
        *(t.data_ptr() for t in (sig_match, dom_s, running.node_idx,
                                 running.valid, running.anti_sig,
                                 pods.ia_sig, pods.ia_valid, pods.ia_anti,
                                 pods.ia_required)),
        assigned.data_ptr() if assigned is not None else None,
        None if counts is not None else st.counts.data_ptr(),
        st.anti.data_ptr(), st.match_tot.data_ptr(), stream_of(dev))
    pair_counts.launches += 1
    return st


pair_counts.launches = 0


# -- K25: one hop of the ring's counts ----------------------------------------


def ring_hop_plain(counts: torch.Tensor, msat: torch.Tensor,
                   mnode: torch.Tensor, mvalid: torch.Tensor,
                   mns: torch.Tensor, skey: torch.Tensor, satoms: torch.Tensor,
                   sns: torch.Tensor, snsall: torch.Tensor,
                   svalid: torch.Tensor, ndom: torch.Tensor) -> torch.Tensor:
    """Add into counts [sblk, N] (in place; returned) the members of a
    resident block (msat [A, mblk], mnode, mvalid, mns [mblk]) matching
    each signature of a block (skey, satoms [sblk, AT], sns [sblk, NS],
    snsall, svalid [sblk]) at their node's domain under the signature's
    key (ndom [N, TK]): JAX ring_sig_counts' match_block and body. The
    adds are 0/1 in f32, exact in any order below 2**24."""
    sigs = SigTable(key=skey, atoms=satoms, ns=sns, ns_all=snsall,
                    valid=svalid)
    match = sig_match_plain(msat, sigs, mns) & mvalid[None, :]
    mdom = member_domains(key_domains(ndom, skey, skey >= 0), mnode,
                          mnode >= 0)
    return add_counts(counts, match, mdom)


def ring_hop(counts: torch.Tensor, msat: torch.Tensor, mnode: torch.Tensor,
             mvalid: torch.Tensor, mns: torch.Tensor, skey: torch.Tensor,
             satoms: torch.Tensor, sns: torch.Tensor, snsall: torch.Tensor,
             svalid: torch.Tensor, ndom: torch.Tensor) -> torch.Tensor:
    """Kernel K25 on CUDA tensors (adds into counts in place, one launch),
    the plain version on CPU tensors. Exact while every count stays below
    2**24: the kernel's atomics add whole numbers of members in f32, so
    their order does not change the sum."""
    dev = counts.device
    if dev.type == "cpu":
        return ring_hop_plain(counts, msat, mnode, mvalid, mns, skey, satoms,
                              sns, snsall, svalid, ndom)
    sblk, N = counts.shape
    A, mblk = msat.shape
    AT, NS = satoms.shape[1], sns.shape[1]
    TK = ndom.shape[1]
    k = "ring_hop"
    check(k, dev, counts, torch.float32, (sblk, N))
    check(k, dev, msat, torch.bool, (A, mblk))
    check(k, dev, mnode, torch.int32, (mblk,))
    check(k, dev, mvalid, torch.bool, (mblk,))
    check(k, dev, mns, torch.int32, (mblk,))
    check(k, dev, skey, torch.int32, (sblk,))
    check(k, dev, satoms, torch.int32, (sblk, AT))
    check(k, dev, sns, torch.int32, (sblk, NS))
    check(k, dev, snsall, torch.bool, (sblk,))
    check(k, dev, svalid, torch.bool, (sblk,))
    check(k, dev, ndom, torch.int32, (N, TK))
    if sblk * mblk == 0:
        return counts
    _build.launch("tpusched_ring_hop",
                  *ptrs((A, mblk, sblk, AT, NS, N, TK, msat, mnode, mvalid,
                         mns, skey, satoms, sns, snsall, svalid, ndom,
                         counts)), stream_of(dev))
    ring_hop.launches += 1
    return counts


ring_hop.launches = 0


def pair_state_add_pod(snap: ClusterSnapshot, st: PairState,
                       sig_match: torch.Tensor, dom_s: torch.Tensor, p: int,
                       n: torch.Tensor, on: torch.Tensor) -> PairState:
    """Pod p commits to node n (0-dim tensor) when `on` (0-dim bool):
    its selector matches enter counts and match_tot, its required anti
    terms enter anti. Returns a new state (the inputs stay as they
    were). The plain scan's update; K4's pairwise variant does the same
    in the kernel."""
    M = snap.running.valid.shape[0]
    S = dom_s.shape[0]
    dev = dom_s.device
    dom_n = dom_s[:, n]                                      # [S]
    col = sig_match[:, M + p]                                # [S]
    counts = st.counts.clone()
    counts.index_put_((torch.arange(S, device=dev), dom_n.clamp(min=0).long()),
                      (col & (dom_n >= 0) & on).to(torch.float32),
                      accumulate=True)
    match_tot = st.match_tot + (col & on).to(torch.float32)
    anti = st.anti.clone()
    holds = pod_anti_holds(snap.pods)[p]
    for t in range(snap.pods.ia_key.shape[1]):
        s = snap.pods.ia_sig[p, t].clamp(min=0).long()
        dom_pn = dom_s[s, n]
        hold = holds[t] & on & (dom_pn >= 0)
        anti.index_put_((s.view(1), dom_pn.clamp(min=0).long().view(1)),
                        hold.to(torch.float32).view(1), accumulate=True)
    return PairState(counts=counts, anti=anti, match_tot=match_tot)


def pair_state_evict(snap: ClusterSnapshot, st: PairState,
                     sig_match: torch.Tensor, dom_s: torch.Tensor,
                     evict_m: torch.Tensor) -> PairState:
    """Evicted running members leave the state (JAX pair_state_evict):
    their selector matches leave counts and match_tot, their required
    anti terms leave anti. Returns a new state; every add is -1 or 0 on
    an integer count, exact in any order. K4's preemption variant does
    the same for each victim it evicts."""
    run = snap.running
    M = run.valid.shape[0]
    S = dom_s.shape[0]
    dev = dom_s.device
    node = run.node_idx.long()
    mdom = dom_s[:, node.clamp(min=0)]                       # [S, M]
    hit = sig_match[:, :M] & evict_m[None, :]
    ok = hit & (mdom >= 0) & (node >= 0)[None, :]
    rows = torch.arange(S, device=dev)[:, None].expand_as(mdom)
    counts = st.counts.clone()
    counts.index_put_((rows, mdom.clamp(min=0).long()),
                      -ok.to(torch.float32), accumulate=True)
    match_tot = st.match_tot - hit.to(torch.float32).sum(dim=1)
    anti = st.anti.clone()
    asig = run.anti_sig                                      # [M, J]
    if asig.shape[1] and S:
        sclip = asig.clamp(min=0).long()
        dom_mj = dom_s[sclip, node.clamp(min=0)[:, None]]    # [M, J]
        okj = ((asig >= 0) & evict_m[:, None] & (node >= 0)[:, None]
               & (dom_mj >= 0))
        anti.index_put_((sclip, dom_mj.clamp(min=0).long()),
                        -okj.to(torch.float32), accumulate=True)
    return PairState(counts=counts, anti=anti, match_tot=match_tot)


# -- constraint evaluation from the state --------------------------------------


def _node_counts(st: PairState, dom_s: torch.Tensor):
    """(counts at each node's domain [S, N], has-key [S, N], max count
    over nodes with the key [S])."""
    node_count_sig = torch.gather(st.counts, 1, dom_s.clamp(min=0).long())
    has_key_sig = dom_s >= 0
    zero = torch.zeros((), dtype=torch.float32, device=dom_s.device)
    max_count_sig = torch.where(has_key_sig, node_count_sig, zero).amax(
        dim=1)
    return node_count_sig, has_key_sig, max_count_sig


def _anti_at(st: PairState, dom_s: torch.Tensor) -> torch.Tensor:
    """[S, N] int32 holder counts at each node's domain (0 without the
    key)."""
    anti_at = torch.gather(st.anti, 1, dom_s.clamp(min=0).long())
    return torch.where(dom_s >= 0, anti_at,
                       torch.zeros((), dtype=torch.float32,
                                   device=dom_s.device)).to(torch.int32)


def _self_adj(snap: ClusterSnapshot, sig_match: torch.Tensor,
              dom_s: torch.Tensor, s: torch.Tensor, esn: torch.Tensor,
              pod_idx: torch.Tensor):
    """What each pod's own contribution adds when it is taken to sit on
    esn[p] (-1: nowhere), for checking a pod after its commit as
    upstream checks it before: (adj [P, N] f32, the per-node count of
    the pod's own domain under signature s[p]; active [P] f32, whether
    it counts in a domain; committed [P] f32, whether it counts in
    match_tot, which ignores domains)."""
    M = snap.running.valid.shape[0]
    own_dom = dom_s[s, esn.clamp(min=0).long()]              # [P]
    self_match = sig_match[s, M + pod_idx]                   # [P]
    committed = self_match & (esn >= 0)
    active = committed & (own_dom >= 0)
    adj = (active[:, None] & (dom_s[s] == own_dom[:, None])).to(torch.float32)
    return adj, active.to(torch.float32), committed.to(torch.float32)


def symmetric_anti_block(snap: ClusterSnapshot, st: PairState,
                         sig_match: torch.Tensor, dom_s: torch.Tensor,
                         exclude_self_node: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """[P, N] bool: node n lies in a domain holding a required
    anti-affinity term whose selector matches pod p. The [P, S] x [S, N]
    contraction runs in int32, one signature at a time (integer adds:
    exact in any order). exclude_self_node: a pod's own anti terms do
    not count against it where it is taken to sit."""
    M = snap.running.valid.shape[0]
    anti_i = _anti_at(st, dom_s)                             # [S, N]
    matchers = sig_match[:, M:].to(torch.int32)              # [S, P]
    blocked = torch.zeros((matchers.shape[1], dom_s.shape[1]),
                          dtype=torch.int32, device=dom_s.device)
    for s in range(dom_s.shape[0]):
        blocked = blocked + matchers[s][:, None] * anti_i[s][None, :]
    if exclude_self_node is not None:
        pods = snap.pods
        esn = exclude_self_node
        pod_idx = torch.arange(esn.shape[0], device=esn.device)
        holds = pod_anti_holds(pods)
        for t in range(pods.ia_key.shape[1]):
            s = pods.ia_sig[:, t].clamp(min=0).long()
            own_dom = dom_s[s, esn.clamp(min=0).long()]
            active = (holds[:, t] & sig_match[s, M + pod_idx] & (esn >= 0)
                      & (own_dom >= 0))
            sub = active[:, None] & (dom_s[s] == own_dom[:, None])
            blocked = blocked - sub.to(torch.int32)
    return blocked > 0


def pairwise_from_counts(snap: ClusterSnapshot, st: PairState,
                         aff_ok: torch.Tensor, sig_match: torch.Tensor,
                         dom_s: torch.Tensor,
                         exclude_self_node: torch.Tensor | None = None):
    """Batched [P, N] spread and inter-pod evaluation against one state
    (JAX pairwise_from_counts). aff_ok: the required node-affinity mask
    (spread domain discovery honours it). exclude_self_node: optional
    [P] int32 node each pod is taken to sit on (-1: none), whose own
    contribution the checks then leave out; no solve path passes it,
    it is the reference `ia_ok_at_choice` (K14) is held to. Returns
    (spread_ok, spread_pen, ia_ok, ia_raw), each [P, N]."""
    nodes, pods = snap.nodes, snap.pods
    dev = dom_s.device
    node_count_sig, has_key_sig, max_count_sig = _node_counts(st, dom_s)
    P, N = aff_ok.shape
    M = snap.running.valid.shape[0]
    pod_idx = torch.arange(P, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    inf = torch.full((), torch.inf, dtype=torch.float32, device=dev)
    esn = exclude_self_node

    spread_ok = torch.ones((P, N), dtype=torch.bool, device=dev)
    spread_pen = torch.zeros((P, N), dtype=torch.float32, device=dev)
    for c in range(pods.ts_key.shape[1]):
        s = pods.ts_sig[:, c].clamp(min=0).long()
        valid_c = pods.ts_valid[:, c]
        nc = node_count_sig[s]                               # [P, N]
        if esn is not None:
            nc = nc - _self_adj(snap, sig_match, dom_s, s, esn, pod_idx)[0]
        hk = has_key_sig[s]
        eligible = nodes.valid[None, :] & aff_ok & hk
        min_c = torch.where(eligible, nc, inf).amin(dim=1)
        min_c = torch.where(eligible.any(dim=1), min_c, zero)
        dns = pods.ts_when[:, c] == DO_NOT_SCHEDULE
        ok_c = hk & (nc + 1.0 - min_c[:, None]
                     <= pods.ts_max_skew[:, c][:, None])
        spread_ok &= torch.where((valid_c & dns)[:, None], ok_c, True)
        mx = torch.where(hk, nc, max_count_sig[s][:, None])
        spread_pen = spread_pen + torch.where((valid_c & ~dns)[:, None], mx,
                                              zero)

    ia_ok = torch.ones((P, N), dtype=torch.bool, device=dev)
    ia_raw = torch.zeros((P, N), dtype=torch.float32, device=dev)
    for t in range(pods.ia_key.shape[1]):
        s = pods.ia_sig[:, t].clamp(min=0).long()
        valid_t = pods.ia_valid[:, t]
        nc = node_count_sig[s]
        match_tot = st.match_tot[s]
        if esn is not None:
            adj, _, active_tot = _self_adj(snap, sig_match, dom_s, s, esn,
                                           pod_idx)
            nc = nc - adj
            match_tot = match_tot - active_tot
        hk = has_key_sig[s]
        node_has = hk & (nc > 0)
        anti = pods.ia_anti[:, t]
        req = pods.ia_required[:, t]
        # Required positive affinity: with no matching member anywhere
        # (match_tot counts key-less nodes too) a pod matching its own
        # selector may take any node with the key.
        self_match = sig_match[s, M + pod_idx]
        all_zero = match_tot <= 0
        pos_ok = node_has | ((all_zero & self_match)[:, None] & hk)
        ok_t = torch.where(anti[:, None], ~node_has, pos_ok)
        ia_ok &= torch.where((valid_t & req)[:, None], ok_t, True)
        w = torch.where(anti, -pods.ia_weight[:, t], pods.ia_weight[:, t])
        ia_raw = ia_raw + torch.where((valid_t & ~req)[:, None] & node_has,
                                      w[:, None], zero)

    # Symmetric required anti-affinity: applies to every pod.
    ia_ok &= ~symmetric_anti_block(snap, st, sig_match, dom_s, esn)
    return spread_ok, spread_pen, ia_ok, ia_raw


def pairwise_row(snap: ClusterSnapshot, st: PairState,
                 sig_match: torch.Tensor, dom_s: torch.Tensor, p: int,
                 aff_ok_p: torch.Tensor):
    """Pod p's [N] row of pairwise_from_counts (the scan checks before
    it commits, so there is no self-exclusion). Returns (spread_ok,
    spread_pen, ia_ok, ia_raw)."""
    nodes, pods = snap.nodes, snap.pods
    dev = dom_s.device
    node_count_sig, has_key_sig, max_count_sig = _node_counts(st, dom_s)
    N = nodes.valid.shape[0]
    M = snap.running.valid.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    inf = torch.full((), torch.inf, dtype=torch.float32, device=dev)

    spread_ok = torch.ones(N, dtype=torch.bool, device=dev)
    spread_pen = torch.zeros(N, dtype=torch.float32, device=dev)
    for c in range(pods.ts_key.shape[1]):
        s = pods.ts_sig[p, c].clamp(min=0).long()
        valid_c = pods.ts_valid[p, c]
        nc = node_count_sig[s]
        hk = has_key_sig[s]
        eligible = nodes.valid & aff_ok_p & hk
        min_c = torch.where(eligible, nc, inf).amin()
        min_c = torch.where(eligible.any(), min_c, zero)
        dns = pods.ts_when[p, c] == DO_NOT_SCHEDULE
        ok_c = hk & (nc + 1.0 - min_c <= pods.ts_max_skew[p, c])
        spread_ok &= torch.where(valid_c & dns, ok_c, True)
        pen_c = torch.where(hk, nc, max_count_sig[s])
        spread_pen = spread_pen + torch.where(valid_c & ~dns, pen_c, zero)

    ia_ok = torch.ones(N, dtype=torch.bool, device=dev)
    ia_raw = torch.zeros(N, dtype=torch.float32, device=dev)
    for t in range(pods.ia_key.shape[1]):
        s = pods.ia_sig[p, t].clamp(min=0).long()
        valid_t = pods.ia_valid[p, t]
        nc = node_count_sig[s]
        hk = has_key_sig[s]
        node_has = hk & (nc > 0)
        anti = pods.ia_anti[p, t]
        req = pods.ia_required[p, t]
        all_zero = st.match_tot[s] <= 0
        self_match = sig_match[s, M + p]
        pos_ok = node_has | (all_zero & self_match & hk)
        ok_t = torch.where(anti, ~node_has, pos_ok)
        ia_ok &= torch.where(valid_t & req, ok_t, True)
        w = torch.where(anti, -pods.ia_weight[p, t], pods.ia_weight[p, t])
        ia_raw = ia_raw + torch.where(valid_t & ~req & node_has, w, zero)

    # Symmetric anti: the [S] match column x [S, N] holder counts, int32.
    match_vec = sig_match[:, M + p].to(torch.int32)
    sym = (match_vec[:, None] * _anti_at(st, dom_s)).sum(dim=0) > 0
    ia_ok &= ~sym
    return spread_ok, spread_pen, ia_ok, ia_raw


# -- K11: pairwise rows of every pod against one state (ScoreBatch) ------------


def pairwise_batch_plain(snap: ClusterSnapshot, st: PairState,
                         aff_ok: torch.Tensor, sig_match: torch.Tensor,
                         dom_s: torch.Tensor, with_ia_ok: bool = False):
    """(pair_ok, ts_score, ia_score), each [P, N]: spread_ok & ia_ok, the
    inverse-normalised spread penalty and the min-max-normalised
    inter-pod raw score (per row, over valid nodes); with_ia_ok appends
    ia_ok alone (inter-pod and symmetric anti-affinity, no spread). A
    tenant batch goes tenant by tenant."""
    if dom_s.dim() == 3:
        return per_tenant(pairwise_batch_plain, dom_s.shape[0], snap, st,
                          aff_ok, sig_match, dom_s, with_ia_ok)
    spread_ok, pen, ia_ok, raw = pairwise_from_counts(snap, st, aff_ok,
                                                      sig_match, dom_s)
    nvalid = snap.nodes.valid
    out = (spread_ok & ia_ok, kscore.inverse_normalize(pen, nvalid),
           kscore.minmax_normalize(raw, nvalid))
    return out + (ia_ok,) if with_ia_ok else out


def _pair_term_args(k: str, snap: ClusterSnapshot, aff_ok: torch.Tensor,
                    sig_match: torch.Tensor, dom_s: torch.Tensor,
                    st: PairState) -> tuple:
    """Check the arguments K4's pairwise variant and K11 share
    (kernels.h: the pairwise block of both entry points, the state's
    three tensors last); a tenant batch has a leading [B] on each."""
    dev = dom_s.device
    pods, nodes = snap.pods, snap.nodes
    lead = dom_s.shape[:-2]                # () or (B,): the tenant axis
    S, N = dom_s.shape[-2:]
    P = pods.valid.shape[-1]
    M = snap.running.valid.shape[-1]
    C, IT = pods.ts_sig.shape[-1], pods.ia_sig.shape[-1]
    if C > MAX_C:
        raise ValueError(f"{k}: {C} spread constraints per pod, the kernel "
                         f"takes <= {MAX_C}")
    check(k, dev, dom_s, torch.int32, (*lead, S, N))
    check(k, dev, sig_match, torch.bool, (*lead, S, M + P))
    check(k, dev, nodes.valid, torch.bool, (*lead, N))
    check(k, dev, aff_ok, torch.bool, (*lead, P, N))
    check(k, dev, pods.ts_sig, torch.int32, (*lead, P, C))
    check(k, dev, pods.ts_valid, torch.bool, (*lead, P, C))
    check(k, dev, pods.ts_when, torch.int8, (*lead, P, C))
    check(k, dev, pods.ts_max_skew, torch.float32, (*lead, P, C))
    _check_ia_terms(k, dev, pods, (*lead, P), IT)
    check(k, dev, pods.ia_weight, torch.float32, (*lead, P, IT))
    _check_state(k, dev, st, (*lead, S), N)
    return (S, C, IT, M, dom_s, sig_match, nodes.valid, aff_ok, pods.ts_sig,
            pods.ts_valid, pods.ts_when, pods.ts_max_skew, pods.ia_sig,
            pods.ia_valid, pods.ia_anti, pods.ia_required, pods.ia_weight,
            st.counts, st.anti, st.match_tot)


def _check_ia_terms(k: str, dev, pods: PodArrays, rows: tuple,
                    IT: int) -> None:
    """rows: the pod axis with its tenant axis, (P,) or (B, P)."""
    check(k, dev, pods.ia_sig, torch.int32, (*rows, IT))
    for t in (pods.ia_valid, pods.ia_anti, pods.ia_required):
        check(k, dev, t, torch.bool, (*rows, IT))


def _check_state(k: str, dev, st: PairState, sigs: tuple, N: int) -> None:
    """sigs: the signature axis with its tenant axis, (S,) or (B, S)."""
    check(k, dev, st.counts, torch.float32, (*sigs, N))
    check(k, dev, st.anti, torch.float32, (*sigs, N))
    check(k, dev, st.match_tot, torch.float32, sigs)


def _zero_state(lead: tuple, S: int, N: int, dev) -> PairState:
    return PairState(
        counts=torch.zeros((*lead, S, N), dtype=torch.float32, device=dev),
        anti=torch.zeros((*lead, S, N), dtype=torch.float32, device=dev),
        match_tot=torch.zeros((*lead, S), dtype=torch.float32, device=dev))


def copy_state(st: PairState) -> PairState:
    return PairState(counts=st.counts.clone(), anti=st.anti.clone(),
                     match_tot=st.match_tot.clone())


def pairwise_batch(snap: ClusterSnapshot, st: PairState,
                   aff_ok: torch.Tensor, sig_match: torch.Tensor,
                   dom_s: torch.Tensor, with_ia_ok: bool = False):
    """Kernel K11 on CUDA tensors, the plain version on CPU tensors."""
    dev = dom_s.device
    if dev.type == "cpu":
        return pairwise_batch_plain(snap, st, aff_ok, sig_match, dom_s,
                                    with_ia_ok)
    shape = aff_ok.shape                   # (P, N) or (B, P, N)
    B = shape[0] if len(shape) == 3 else 1
    P, N = shape[-2:]
    terms = _pair_term_args("pairwise_batch", snap, aff_ok, sig_match,
                            dom_s, st)
    pair_ok = torch.empty(shape, dtype=torch.bool, device=dev)
    ts_score = torch.empty(shape, dtype=torch.float32, device=dev)
    ia_score = torch.empty(shape, dtype=torch.float32, device=dev)
    ia_ok = (torch.empty(shape, dtype=torch.bool, device=dev)
             if with_ia_ok else None)
    out = (pair_ok, ts_score, ia_score) + ((ia_ok,) if with_ia_ok else ())
    if pair_ok.numel() == 0:
        return out
    _build.launch("tpusched_pairwise_batch",
                  *ptrs((B, P, N, *terms, pair_ok, ts_score, ia_score,
                         ia_ok)), stream_of(dev))
    pairwise_batch.launches += 1
    if with_ia_ok:
        pairwise_batch.ia_ok_launches += 1
    return out


pairwise_batch.launches = 0
pairwise_batch.ia_ok_launches = 0   # of them, with ia_ok out


# -- K10 + commit: committed pods in and out of the state ---------------------


def pair_commit_plain(snap: ClusterSnapshot, st: PairState,
                      sig_match: torch.Tensor, dom_s: torch.Tensor,
                      choice: torch.Tensor, commit_mask: torch.Tensor,
                      sign: float = 1.0) -> PairState:
    """JAX pair_state_commit, in place: add (sign +1) or take back (sign
    -1) the contributions of the pending pods committed to choice[p]
    where commit_mask[p]; the pods are the rows of `snap.pods` (a
    compacted view's too) and sig_match's member columns past the
    running ones. The state passed in is consumed, as `pair_commit`'s
    is: its tensors take the adds and are returned, so a caller that
    still read the old state would read the new one. Every added value
    is 0 or +-1 and every count an integer below 2**24, so the sums are
    exact in any order. A tenant batch goes tenant by tenant, each into
    its own slices of the same tensors."""
    if dom_s.dim() == 3:
        for b in range(dom_s.shape[0]):
            pair_commit_plain(snap.tenant(b), st.tenant(b), sig_match[b],
                              dom_s[b], choice[b], commit_mask[b], sign)
        return st
    M = snap.running.valid.shape[0]
    S = dom_s.shape[0]
    dev = dom_s.device
    ch = choice.clamp(min=0).long()
    pod_dom = dom_s[:, ch]                                   # [S, P]
    on = sig_match[:, M:] & commit_mask[None, :]
    rows = torch.arange(S, device=dev)[:, None].expand_as(pod_dom)
    st.counts.index_put_((rows, pod_dom.clamp(min=0).long()),
                         (on & (pod_dom >= 0)).to(torch.float32) * sign,
                         accumulate=True)
    st.match_tot.add_(on.to(torch.float32).sum(dim=1) * sign)
    holds = pod_anti_holds(snap.pods)
    for t in range(snap.pods.ia_key.shape[1]):
        s = snap.pods.ia_sig[:, t].clamp(min=0).long()
        dom_p = dom_s[s, ch]
        hold = holds[:, t] & commit_mask & (dom_p >= 0)
        st.anti.index_put_((s, dom_p.clamp(min=0).long()),
                           hold.to(torch.float32) * sign, accumulate=True)
    return st


def check_commit_tables(snap: ClusterSnapshot, st: PairState,
                        sig_match: torch.Tensor, dom_s: torch.Tensor) -> None:
    """Check the tables `pair_commit` reads that do not change inside a
    solve: the domains, the member table, the pods' inter-pod terms and
    the state's shapes. A solve checks them once, where its pair state is
    made; `pair_commit` itself checks only what varies a call."""
    dev = dom_s.device
    k = "pair_commit"
    lead = dom_s.shape[:-2]                # () or (B,): the tenant axis
    S, N = dom_s.shape[-2:]
    P = snap.pods.valid.shape[-1]
    M = snap.running.valid.shape[-1]
    check(k, dev, dom_s, torch.int32, (*lead, S, N))
    check(k, dev, sig_match, torch.bool, (*lead, S, M + P))
    _check_ia_terms(k, dev, snap.pods, (*lead, P), snap.pods.ia_sig.shape[-1])
    _check_state(k, dev, st, (*lead, S), N)


def pair_commit(snap: ClusterSnapshot, st: PairState,
                sig_match: torch.Tensor, dom_s: torch.Tensor,
                choice: torch.Tensor, commit_mask: torch.Tensor,
                sign: float = 1.0) -> PairState:
    """K10's commit entry point on CUDA tensors, the plain version on CPU
    tensors. The state passed in is consumed: the commit adds into its
    tensors and returns them (no copy); a caller that needs the state as
    it was keeps its own copy. The tables that do not change inside a
    solve are checked once by `check_commit_tables`; a call checks
    choice, commit_mask and sign."""
    dev = dom_s.device
    if dev.type == "cpu":
        return pair_commit_plain(snap, st, sig_match, dom_s, choice,
                                 commit_mask, sign)
    k = "pair_commit"
    if sign not in (1.0, -1.0):
        raise ValueError(f"{k}: sign {sign}, want +1 or -1")
    lead = dom_s.shape[:-2]                # () or (B,): the tenant axis
    S, N = dom_s.shape[-2:]
    P = choice.shape[-1]
    check(k, dev, choice, torch.int32, (*lead, P))
    check(k, dev, commit_mask, torch.bool, (*lead, P))
    if S * P == 0 or dom_s.numel() == 0:
        return st
    _build.launch("tpusched_pair_commit",
                  *ptrs((lead[0] if lead else 1, S, N,
                         sig_match.shape[-1] - P, P,
                         snap.pods.ia_sig.shape[-1], sig_match, dom_s,
                         snap.pods.ia_sig, snap.pods.ia_valid,
                         snap.pods.ia_anti, snap.pods.ia_required, choice,
                         commit_mask, int(sign), st.counts, st.anti,
                         st.match_tot)),
                  stream_of(dev))
    pair_commit.launches += 1
    return st


pair_commit.launches = 0


# -- K14: the inter-pod verdict at each pod's chosen node ----------------------


def ia_ok_at_choice_plain(snap: ClusterSnapshot, st: PairState,
                          sig_match: torch.Tensor, dom_s: torch.Tensor,
                          choice: torch.Tensor,
                          esn: torch.Tensor) -> torch.Tensor:
    """[P] bool: `pairwise_from_counts(..., exclude_self_node=esn)`'s
    ia_ok at column choice[p], from O(S * P) gathers (JAX
    ia_ok_at_choice). Rows with choice < 0 are evaluated at node 0 and
    left to the caller to mask. A tenant batch goes tenant by tenant."""
    if dom_s.dim() == 3:
        return per_tenant(ia_ok_at_choice_plain, dom_s.shape[0], snap, st,
                          sig_match, dom_s, choice, esn)
    pods = snap.pods
    M = snap.running.valid.shape[0]
    P = pods.valid.shape[0]
    dev = dom_s.device
    pod_idx = torch.arange(P, device=dev)
    ch = choice.clamp(min=0).long()
    esn_c = esn.clamp(min=0).long()
    holds = pod_anti_holds(pods)
    ok = torch.ones(P, dtype=torch.bool, device=dev)
    own = []
    for t in range(pods.ia_key.shape[1]):
        s = pods.ia_sig[:, t].clamp(min=0).long()
        d = dom_s[s, ch]
        self_match = sig_match[s, M + pod_idx]
        committed = self_match & (esn >= 0)
        own_dom = dom_s[s, esn_c]
        # _self_adj at n = choice: the pod's own contribution counts
        # only where the node's domain is its own node's domain.
        active = committed & (own_dom >= 0) & (d == own_dom)
        nc = st.counts[s, d.clamp(min=0).long()] - active.to(torch.float32)
        hk = d >= 0
        node_has = hk & (nc > 0)
        all_zero = (st.match_tot[s] - committed.to(torch.float32)) <= 0
        pos_ok = node_has | (all_zero & self_match & hk)
        ok_t = torch.where(pods.ia_anti[:, t], ~node_has, pos_ok)
        ok &= torch.where(pods.ia_valid[:, t] & pods.ia_required[:, t], ok_t,
                          True)
        own.append(holds[:, t] & active)
    # The symmetric-anti column at the chosen node, in int32.
    d_all = dom_s[:, ch]                                     # [S, P]
    anti_at = torch.gather(st.anti, 1, d_all.clamp(min=0).long())
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    anti_i = torch.where(d_all >= 0, anti_at, zero).to(torch.int32)
    blocked = (sig_match[:, M:].to(torch.int32) * anti_i).sum(dim=0)
    for a in own:
        blocked = blocked - a.to(torch.int32)
    return ok & ~(blocked > 0)


def ia_ok_at_choice(snap: ClusterSnapshot, st: PairState,
                    sig_match: torch.Tensor, dom_s: torch.Tensor,
                    choice: torch.Tensor, esn: torch.Tensor) -> torch.Tensor:
    """Kernel K14 on CUDA tensors, the plain version on CPU tensors."""
    dev = dom_s.device
    if dev.type == "cpu":
        return ia_ok_at_choice_plain(snap, st, sig_match, dom_s, choice,
                                     esn)
    pods = snap.pods
    lead = dom_s.shape[:-2]                # () or (B,): the tenant axis
    S, N = dom_s.shape[-2:]
    P = pods.valid.shape[-1]
    M = snap.running.valid.shape[-1]
    IT = pods.ia_sig.shape[-1]
    k = "ia_ok_at_choice"
    check(k, dev, dom_s, torch.int32, (*lead, S, N))
    check(k, dev, sig_match, torch.bool, (*lead, S, M + P))
    _check_ia_terms(k, dev, pods, (*lead, P), IT)
    _check_state(k, dev, st, (*lead, S), N)
    check(k, dev, choice, torch.int32, (*lead, P))
    check(k, dev, esn, torch.int32, (*lead, P))
    ok = torch.empty((*lead, P), dtype=torch.bool, device=dev)
    if ok.numel() == 0:
        return ok
    _build.launch("tpusched_ia_at_choice",
                  *ptrs((lead[0] if lead else 1, P, N, S, IT, M, dom_s, sig_match, pods.ia_sig,
                         pods.ia_valid, pods.ia_anti, pods.ia_required,
                         st.counts, st.anti, st.match_tot, choice, esn, ok)),
                  stream_of(dev))
    ia_ok_at_choice.launches += 1
    return ok


ia_ok_at_choice.launches = 0
