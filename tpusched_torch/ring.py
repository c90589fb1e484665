"""The blockwise pairwise count ring: the port of `tpusched/ring.py`.

The initial domain counts counts[s, d] (members matching signature s in
domain d of its topology key) are the contraction of an [S, M+P] match
against the members' placement. Around the mesh's p ring they are
computed without the [S, M+P] match on any rank:

  * member blocks (label satisfaction columns, namespace, node,
    validity) stay resident, block i on the ring's rank i;
  * signature blocks (selector atoms, topology key, namespace scope)
    rotate one rank on after every hop, each with its [sblk, N] counts;
  * after ndev hops every block is home with complete counts, and the
    home blocks are gathered over the ring, so every rank holds [S, N].

Each hop is kernel K25 (`kernels/pairwise.ring_hop`, the match fused
with the count by domain). The exchange is one buffer a hop (the five
signature arrays and the counts packed together) through
`torch.distributed.batch_isend_irecv` with the ring's neighbours; at one
rank it is the identity, as `ppermute` to itself is. The adds are whole
numbers in f32, so the result equals the dense count (K10) bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from tpusched_torch.kernels import pairwise as kpair
from tpusched_torch.mesh import POD_AXIS, Mesh
from tpusched_torch.snapshot import ClusterSnapshot


def _pad_to(x: torch.Tensor, mult: int, axis: int, fill) -> torch.Tensor:
    """x with `axis` padded by `fill` up to a multiple of `mult`."""
    rem = (-x.shape[axis]) % mult
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=axis)


@dataclasses.dataclass
class RingInputs:
    """The ring's arrays, padded to ndev blocks as JAX pads them: members
    (msat False, mnode -1, mvalid False, mns -1) and signatures (key,
    atoms and ns -1, ns_all and valid False)."""

    msat: torch.Tensor     # [A, Xp] bool
    mnode: torch.Tensor    # [Xp] int32
    mvalid: torch.Tensor   # [Xp] bool
    mns: torch.Tensor      # [Xp] int32
    skey: torch.Tensor     # [Sp] int32
    satoms: torch.Tensor   # [Sp, AT] int32
    sns: torch.Tensor      # [Sp, NS] int32
    snsall: torch.Tensor   # [Sp] bool
    svalid: torch.Tensor   # [Sp] bool
    ndom: torch.Tensor     # [N, TK] int32 node domain per topology key
    ndev: int

    def members(self, i: int) -> tuple:
        """Member block i: (msat [A, mblk], mnode, mvalid, mns)."""
        mblk = self.mnode.shape[0] // self.ndev
        cut = slice(i * mblk, (i + 1) * mblk)
        return (self.msat[:, cut].contiguous(), self.mnode[cut],
                self.mvalid[cut], self.mns[cut])

    def sigs(self, i: int) -> tuple:
        """Signature block i: (skey, satoms, sns, snsall, svalid)."""
        sblk = self.skey.shape[0] // self.ndev
        cut = slice(i * sblk, (i + 1) * sblk)
        return (self.skey[cut], self.satoms[cut], self.sns[cut],
                self.snsall[cut], self.svalid[cut])


def ring_inputs(snap: ClusterSnapshot, member_sat_t: torch.Tensor,
                assigned: torch.Tensor, ndev: int) -> RingInputs:
    """The members [running | pending] (a pending pod counts at
    assigned[p] >= 0) and the signatures, padded to ndev blocks."""
    run, pods, sigs = snap.running, snap.pods, snap.sigs
    return RingInputs(
        msat=_pad_to(member_sat_t, ndev, 1, False),
        mnode=_pad_to(torch.cat([run.node_idx, assigned]), ndev, 0, -1),
        mvalid=_pad_to(torch.cat([run.valid, assigned >= 0]), ndev, 0, False),
        mns=_pad_to(torch.cat([run.namespace, pods.namespace]), ndev, 0, -1),
        skey=_pad_to(sigs.key, ndev, 0, -1),
        satoms=_pad_to(sigs.atoms, ndev, 0, -1),
        sns=_pad_to(sigs.ns, ndev, 0, -1),
        snsall=_pad_to(sigs.ns_all, ndev, 0, False),
        svalid=_pad_to(sigs.valid, ndev, 0, False),
        ndom=snap.nodes.domain, ndev=ndev)


def _pack(block: tuple, counts: torch.Tensor) -> torch.Tensor:
    """One int32 buffer of a signature block and its counts (the f32
    counts by their bits, the bools as 0/1), each field a contiguous
    run: [key | ns_all | valid | atoms | ns | counts]."""
    skey, satoms, sns, snsall, svalid = block
    return torch.cat([skey, snsall.to(torch.int32), svalid.to(torch.int32),
                      satoms.reshape(-1), sns.reshape(-1),
                      counts.view(torch.int32).reshape(-1)])


def _unpack(buf: torch.Tensor, sblk: int, AT: int, NS: int,
            N: int) -> tuple:
    """(block, counts) of a _pack buffer; counts is a view into buf."""
    o = [0]

    def take(n: int) -> torch.Tensor:
        o[0] += n
        return buf[o[0] - n:o[0]]

    skey = take(sblk)
    snsall, svalid = take(sblk).bool(), take(sblk).bool()
    satoms = take(sblk * AT).view(sblk, AT)
    sns = take(sblk * NS).view(sblk, NS)
    counts = take(sblk * N).view(torch.float32).view(sblk, N)
    return (skey, satoms, sns, snsall, svalid), counts


def ring_sig_counts(snap: ClusterSnapshot, member_sat_t: torch.Tensor,
                    assigned: torch.Tensor, mesh: Mesh,
                    hop=kpair.ring_hop) -> torch.Tensor:
    """[S, N] f32 domain counts, computed blockwise around this rank's p
    ring (every rank of the ring calls it; each n column runs its own
    ring). member_sat_t: [A, M+P] atom satisfaction over member labels
    (pairwise.member_label_sat_t); assigned: [P] int32 committed node a
    pending pod (-1: not placed). Equals pairwise.pair_counts' counts.
    hop: K25 (`kernels/pairwise.ring_hop`) or its plain version."""
    ndev = mesh.shape[POD_AXIS]
    S, AT = snap.sigs.atoms.shape
    NS = snap.sigs.ns.shape[1]
    N = snap.nodes.valid.shape[0]
    inp = ring_inputs(snap, member_sat_t, assigned, ndev)
    sblk = inp.skey.shape[0] // ndev
    p, _ = mesh.coords
    mine = inp.members(p)
    buf = _pack(inp.sigs(p), torch.zeros((sblk, N), dtype=torch.float32,
                                         device=inp.skey.device))
    for _ in range(ndev):
        block, counts = _unpack(buf, sblk, AT, NS, N)
        hop(counts, *mine, *block, inp.ndom)
        buf = mesh.p_shift(buf)
    home = _unpack(buf, sblk, AT, NS, N)[1]
    return mesh.p_gather(home)[:S]


def ring_sig_counts_rotated(snap: ClusterSnapshot, member_sat_t: torch.Tensor,
                            assigned: torch.Tensor, ndev: int,
                            hop=kpair.ring_hop) -> torch.Tensor:
    """What an ndev-rank ring computes, in one process on one device:
    signature block j meets member block (j + h) mod ndev at hop h, as
    it does on rank (j + h) mod ndev of the ring. The tests and
    chip_smoke.py hold `hop` to its plain version this way, at the hop
    shapes of a ring of ndev ranks."""
    S = snap.sigs.key.shape[0]
    N = snap.nodes.valid.shape[0]
    inp = ring_inputs(snap, member_sat_t, assigned, ndev)
    sblk = inp.skey.shape[0] // ndev
    out = []
    for j in range(ndev):
        counts = torch.zeros((sblk, N), dtype=torch.float32,
                             device=inp.skey.device)
        block = inp.sigs(j)
        for h in range(ndev):
            hop(counts, *inp.members((j + h) % ndev), *block, inp.ndom)
        out.append(counts)
    return torch.cat(out)[:S]
