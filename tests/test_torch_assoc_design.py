"""The redesigned log-depth forward (kernel row 9) and dedup claim (row
8b) emulated in numpy on the CPU, on ``chip_smoke.py``'s phase-13 input
makers (numpy only).  The kernels run on the card only: ``chip_smoke.py``
holds them against their plain versions bit for bit (phase 13); here the
designs' schedules are held against the JAX package.

The split scan in the kernel's order: level 0 staged once, the alive
recursion and the map pass's up-sweep (the [K, K] parts of the
combines), the restart pass (the [K] vectors and flags, in place over
the same pairing) beside the map pass's down-sweep of the levels above
the first (only the prefixes that points before the first restart read;
an unformed one reads as NaN here), level 0's prefixes before the first
restart formed into the consumed odd slots, then the scores, each entry
max_k(a[k] + b[k][j]) in k order with one float32 rounding per add, as
the kernel computes it.  Held
against ``reporter_tpu.ops.viterbi._forward_assoc`` (jitted) and the
port's ``_forward_assoc_plain``.

The claim: each run of 1,024 keys deduplicated in its own set, the runs'
distinct keys inserted into a global set (linear probing over
next_pow2(2m) slots, the (-1, -1) key its own slot) in a shuffled order
of runs, one count update a run, insertion stopped once more than the
budget's keys are won; held against ``torch.unique``.

Tolerance: exact.  The scores bit for bit (float32 adds and compares
only); the distinct counts and every gathered key equal."""

import jax
import numpy as np
import pytest
import torch

import chip_smoke as CS
from reporter_tpu.ops import viterbi as RV
from reporter_tpu_torch.ops import hashtable as H
from reporter_tpu_torch.ops import viterbi as V

F32 = np.float32
NEG = F32(-1e30)

_ref_fwd = jax.jit(jax.vmap(RV._forward_assoc, in_axes=(0, 0, 0, 0, 0, 0, None, 0)))


# -- the split scan ------------------------------------------------------------

def _mm(a, b):
    """a (x) b over leading axes: max_k a[..., i, k] + b[..., k, j], k
    ascending, the first sum kept unless a later one is greater."""
    v = a[..., :, 0:1] + b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        x = a[..., :, k:k + 1] + b[..., k:k + 1, :]
        v = np.where(x > v, x, v)
    return v


def _vec(c, m):
    """c (x) m: max_k c[..., k] + m[..., k, j], k ascending."""
    v = c[..., 0:1] + m[..., 0, :]
    for k in range(1, c.shape[-1]):
        x = c[..., k:k + 1] + m[..., k, :]
        v = np.where(x > v, x, v)
    return v


def _init_reduce(init, P):
    """max_i init[i] + P[..., i, j], i ascending."""
    v = init[0] + P[..., 0, :]
    for i in range(1, len(init)):
        x = init[i] + P[..., i, :]
        v = np.where(x > v, x, v)
    return v


def split_scan(init, emis, logp, gc, valid, thresh):
    """One trace through the kernel's schedule: returns the scores [T-1, K]
    of points 1.. and the steps' breaks [T-1]."""
    T, K = emis.shape
    n = T - 1
    vt = valid[1:] != 0
    cnt, off, poff = [], [], []
    o = po = 0
    c = n
    while True:  # the levels' sizes and offsets, as thread 0 computes them
        off.append(o)
        cnt.append(c)
        poff.append(po)
        if len(cnt) > 1:
            po += (c - 1) // 2
        if c < 2:
            break
        o += c
        c //= 2
    E = sum(cnt)
    eye = np.where(np.eye(K, dtype=bool), F32(0), NEG)
    L = np.empty((E, K, K), F32)
    L[:n] = np.where(vt[:, None, None], logp + emis[1:, None, :], eye)
    pre = np.full((max(po, 1), K, K), np.nan, F32)  # unformed prefixes read as NaN

    # the alive recursion (warp 0): feasibility masks, one step at a time
    feas, ealive = logp > NEG / 2, emis > NEG / 2
    alive = init > NEG / 2
    broke = np.zeros(n, bool)
    for t in range(n):
        conn = (alive[:, None] & feas[t]).any(0)
        broke[t] = gc[t] > thresh[t] or not conn.any()
        if vt[t]:
            alive = ealive[t + 1] if broke[t] else conn & ealive[t + 1]
    flags = np.zeros(E, bool)
    flags[:n] = broke & vt

    # the map pass's up-sweep (beside the recursion on the card)
    for lv in range(len(cnt) - 1):
        m = cnt[lv] // 2
        o = off[lv]
        L[off[lv + 1]:off[lv + 1] + m] = _mm(L[o:o + 2 * m:2], L[o + 1:o + 2 * m:2])
    first = int(np.flatnonzero(flags[:n])[0]) if flags[:n].any() else n

    def pmap(lv, t):
        while t & 1:
            t, lv = (t - 1) // 2, lv + 1
        return L[off[lv]] if t == 0 else pre[poff[lv] + t // 2 - 1]

    def pslot(lv, t):
        while t & 1:
            t, lv = (t - 1) // 2, lv + 1
        return off[lv] + (t - 1 if t else 0)

    # the restart pass: vectors (level 0's the staged emissions, read as
    # -1e30 where the step does not restart) and flags in place over the
    # same pairing; beside each level of its down-sweep, the map pass's
    # down-sweep of the level above, only for the prefixes that points
    # before the first restart read
    vec = np.empty((E, K), F32)
    vec[:n] = emis[1:]
    for lv in range(len(cnt) - 1):
        o, o1 = off[lv], off[lv + 1]
        for e in range(cnt[lv] // 2):
            s1 = o + 2 * e + 1
            ca = vec[s1 - 1] if lv > 0 or flags[s1 - 1] else np.full(K, NEG, F32)
            vec[o1 + e] = vec[s1] if flags[s1] else _vec(ca, L[s1])
            flags[o1 + e] = flags[s1 - 1] | flags[s1]
    levels = len(cnt) - 1
    for lv in range(levels - 1, -1, -1):
        o = off[lv]
        for t in range(2, cnt[lv], 2):
            ps = pslot(lv + 1, t // 2 - 1)
            vec[o + t - 1] = vec[o + t] if flags[o + t] else _vec(vec[ps], L[o + t])
            flags[o + t - 1] = flags[ps] | flags[o + t]
        lu = lv + 1
        if lu < levels:
            for t in range(2, 2 * min((cnt[lu] - 1) // 2, (first >> lu) + 1) + 1, 2):
                pre[poff[lu] + t // 2 - 1] = _mm(pmap(lu + 1, t // 2 - 1), L[off[lu] + t])
    # level 0's prefixes at even positions before the first restart, formed
    # into the consumed odd slot, then the scores
    for t in range(2, min(first, n), 2):
        L[t - 1] = _mm(pmap(1, t // 2 - 1), L[t])
    scores = np.empty((n, K), F32)
    for t in range(n):
        if t >= first:
            scores[t] = vec[pslot(0, t)]
        else:
            P = L[0] if t == 0 else pmap(1, (t - 1) // 2) if t & 1 else L[t - 1]
            scores[t] = _init_reduce(init, P)
    return scores, broke


def _thresholds(e, sparse):
    """Per-step breakage thresholds: the fixed distance, or the sparse
    model's gap-conditioned one (break speed 25 m/s over each time gap)."""
    dt = np.diff(e["times"], axis=1)
    brk = np.full_like(e["gc"], e["brk"])
    return np.maximum(brk, F32(25.0) * np.maximum(dt, 0)).astype(F32) if sparse else brk


CASES = ([(n, 8) for n in (1, 2, 3, 17, 63, 255)]
         + [(n, K) for n in (17, 63) for K in (1, 2, 16, 32)] + [(255, 16), (255, 32)])


@pytest.mark.parametrize("n,K", CASES)
def test_split_scan_equals_reference(n, K):
    """The split scan on every kind of row (``chip_smoke.ASSOC_KINDS``: no
    breaks, a break at t = 0, every step broken, a dead-source break,
    padded tails, an all-padding row, ties), from the emissions at t = 0
    and from a carried init with dead slots, under the fixed and the
    gap-conditioned thresholds: scores bit for bit the jitted reference's
    and ``_forward_assoc_plain``'s, breaks equal."""
    T = n + 1
    e = CS.assoc_edge_inputs(8, T, K, seed=n * 37 + K)
    route = np.zeros_like(e["logp"])
    for sparse in (False, True):
        thresh = _thresholds(e, sparse)
        for init in (e["emis"][:, 0], e["init"]):
            want, _bp, want_broke, _r = _ref_fwd(init, e["logp"], route, e["emis"], e["gc"],
                                                 e["valid"] != 0, None, thresh)
            t = torch.from_numpy
            S, _BP, _BR = V._forward_assoc_plain(
                t(init), torch.zeros(8, dtype=torch.bool), t(e["emis"]), t(e["logp"]),
                t(e["gc"]), t(e["valid"]) != 0, t(thresh))
            for b in range(8):
                got, broke = split_scan(init[b], e["emis"][b], e["logp"][b], e["gc"][b],
                                        e["valid"][b], thresh[b])
                assert np.array_equal(got.view(np.int32), np.asarray(want[b]).view(np.int32)), \
                    (CS.ASSOC_KINDS[b], sparse)
                assert np.array_equal(got.view(np.int32), S[b, 1:].numpy().view(np.int32))
                assert np.array_equal(broke & (e["valid"][b, 1:] != 0), np.asarray(want_broke[b]))


def test_edge_inputs_take_every_branch():
    """The phase-13 maker's rows break where their kind says: a hard break
    at step 0, every step broken, a dead-source break without a hard
    one, a padded tail and an all-padding row, none in the row without
    dead entries; the plain rows hold dead emissions and infeasible
    transitions."""
    e = CS.assoc_edge_inputs(16, 64, 8, seed=3)
    thresh = _thresholds(e, False)
    kinds = {k: [] for k in CS.ASSOC_KINDS}
    for b in range(16):
        _s, broke = split_scan(e["init"][b], e["emis"][b], e["logp"][b], e["gc"][b],
                               e["valid"][b], thresh[b])
        kinds[CS.ASSOC_KINDS[b % 8]].append((broke, e["gc"][b] > thresh[b], e["valid"][b]))
    assert all(br[0] for br, _h, _v in kinds["break at 0"])
    assert all(br.all() for br, _h, _v in kinds["every step broken"])
    assert all((br & ~h).any() for br, h, _v in kinds["dead source"])
    assert all(0 < v.sum() < 64 for _b, _h, v in kinds["padded tail"])
    assert all(v.sum() == 0 for _b, _h, v in kinds["all padding"])
    assert all(not br.any() for br, _h, _v in kinds["no breaks"])
    plain = [b for b in range(16) if CS.ASSOC_KINDS[b % 8] == "plain"]
    assert all((e["emis"][b] <= NEG / 2).any() and (e["logp"][b] <= NEG / 2).any()
               for b in plain)


# -- the claim -----------------------------------------------------------------

def _mix64(x):
    x = x ^ (x >> np.uint64(30))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> np.uint64(27))
    x = x * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def claim(src, dst, m, valid=None, run=1024, seed=0):
    """The claim's design in numpy: returns (count, slot of each key
    (-1 unclaimed), compact index of each slot, compact src, dst).  Runs
    land in a seeded order, each run's distinct keys in a seeded order
    (atomics land in any order); a run inserts nothing once the count is
    past m, a key stops probing once it is."""
    rng = np.random.default_rng(seed)
    n = len(src)
    keys = (src.astype(np.int64).astype(np.uint64) << np.uint64(32)) | (
        dst.astype(np.int64).astype(np.uint64) & np.uint64(0xFFFFFFFF))
    empty = np.uint64(0xFFFFFFFFFFFFFFFF)
    nslots = 1 << max(0, 2 * (m if m else n) - 1).bit_length()
    table = {}  # slot -> key (the keys array where the slot's bit is set)
    hashes = _mix64(keys) & np.uint64(nslots - 1)
    count, slot_of = 0, np.full(n, -1, np.int64)
    sidx = np.full(nslots + 1, -1, np.int64)
    csrc, cdst = np.zeros(max(m, 1), np.int32), np.zeros(max(m, 1), np.int32)
    for r in rng.permutation((n + run - 1) // run):
        idx = np.arange(r * run, min(n, (r + 1) * run))
        if valid is not None:
            idx = idx[valid[idx] != 0]
        distinct = {}  # the run's own set
        for i in idx:
            distinct.setdefault(keys[i], i)
        order = list(distinct.items())
        rng.shuffle(order)
        skip, won, gslot = m > 0 and count > m, [], {}
        for key, i in order:
            if skip:
                continue
            if key == empty:
                h = nslots
                if h not in table:
                    table[h] = key
                    won.append(h)
            else:
                h = int(hashes[i])
                while h in table and table[h] != key:
                    if m > 0 and count > m:
                        h = -1
                        break
                    h = (h + 1) & (nslots - 1)
                if h >= 0 and h not in table:
                    table[h] = key
                    won.append(h)
            gslot[key] = h
        base, count = count, count + len(won)
        for rank, h in enumerate(won):
            sidx[h] = base + rank
            if m and base + rank < m:
                csrc[base + rank] = np.uint32(table[h] >> np.uint64(32)).view(np.int32)
                cdst[base + rank] = np.uint32(table[h] & np.uint64(0xFFFFFFFF)).view(np.int32)
        for i in idx:
            slot_of[i] = gslot.get(keys[i], -1)
    return count, slot_of, sidx, csrc, cdst


@pytest.mark.parametrize("name", ["runs", "all equal", "(-1, -1) only", "all distinct"])
def test_claim_design_equals_unique(name):
    """Each key set of ``chip_smoke.claim_edge_keys`` (the (-1, -1) key
    among runs of repeated keys, all keys equal, all (-1, -1), all
    distinct past the budget m = n // 2): within the budget the distinct
    count is ``torch.unique``'s and every key's compact entry is its own
    key; past it the count exceeds m (the fallback); in count mode (m = 0,
    the mask) the count is the masked keys' distinct count."""
    sets, mask = CS.claim_edge_keys(20_000, seed=1)
    s, d = sets[name]
    n, m = len(s), len(s) // 2
    pair = H._pair_keys(torch.from_numpy(s), torch.from_numpy(d))
    uniq, inv = torch.unique(pair, return_inverse=True)
    for seed in (0, 1):
        count, slot_of, sidx, csrc, cdst = claim(s, d, m, seed=seed)
        if len(uniq) <= m:
            assert count == len(uniq)
            ci = sidx[slot_of]
            assert (slot_of >= 0).all() and (ci < count).all()
            assert np.array_equal(csrc[ci], s) and np.array_equal(cdst[ci], d)
            # gathered through the compact buffer, any function of the key
            # (the probe) gives each position its own key's value
            f = lambda a, b: a.astype(np.int64) * 7919 + b  # noqa: E731
            u_val = f((uniq >> 32).numpy(), (uniq & 0xFFFFFFFF).numpy())
            assert np.array_equal(f(csrc[ci], cdst[ci].view(np.uint32)), u_val[inv.numpy()])
        else:
            assert count > m
        cm = claim(s, d, 0, valid=mask, seed=seed)[0]
        assert cm == int(H.count_distinct_pairs(torch.from_numpy(s), torch.from_numpy(d),
                                                torch.from_numpy(mask)))
    assert (name == "all distinct") == (len(uniq) > m)
