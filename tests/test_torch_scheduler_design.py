"""The equivalence argument of the scheduler kernels' cluster design
(``ray_tpu_torch/csrc/scheduler.cu``), checked on the CPU.

A numpy model does what the kernels do, step for step, over C slices of
the nodes (one slice a CTA):

- ``schedule_classes``: sums over slices added in rank order; the
  bisection's 2^m - 1 midpoints a round, walked down the tree; each slice
  sorted by its packed (util_after, index) keys and scanned, a node placed
  by its local rank plus its rank in every other slice (merge-path
  ranking), its cum by its local scan plus the other slices' scans below
  it;
- ``pg_pack``: each row's util cached and updated only where a bundle
  lands, each slice's least packed key, the least of the slices'.

It must equal ``schedule_classes_plain`` and ``pack_plain`` bit for bit on
the kernels' edge shapes (``workload.class_edge_case`` /
``pack_edge_case``) and the benchmark's, for C in 1, 8 and 16 (the
kernel's 2 levels a round at 8 and 16). The class order is the plain
version's ``_commit_order`` (the kernel sums the supply in one CTA, as
the plain version does in one reduction). The
kernels' branch-free quotient (``fast_quotient``: q = a y, r = fma(-q, d,
a), q + r y with y = 1 / d rounded) is checked against IEEE division with
exact rational arithmetic over its guarded range. No product path uses
the model; the ``cuda`` tests and chip_smoke.py's phase 12 check the
kernels themselves.
"""

import importlib
from fractions import Fraction

import numpy as np
import pytest
import torch

tp = importlib.import_module("ray_tpu_torch._private.scheduler.tpu_policy")
pk = importlib.import_module("ray_tpu_torch._private.scheduler.pg_kernel")
wl = importlib.import_module("ray_tpu_torch._private.scheduler.workload")

F32 = np.float32
EPS = F32(1e-6)
INF = F32(np.inf)
BISECT_STEPS = 40
UPPER_CLAMP = F32(2 ** 30)
SPREAD_PENALTY = F32(1e3)
EMPTY = np.uint64(2 ** 64 - 1)    # an empty slice's least key
# Bisection levels a cluster sum for each cluster size tried: the kernel's
# 2 (LEVELS in scheduler.cu) at its clusters of 8 and 16; one CTA taking
# one level is the sequential search.
LEVELS = {1: 1, 8: 2, 16: 2}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def slices(n, c):
    """[start, end) of each CTA's slice: ceil(n / c) rows each."""
    per = -(-n // c)
    return [(min(n, o * per), min(n, (o + 1) * per)) for o in range(c)]


def rank_sum(parts):
    """Partials added in rank order, as every CTA adds them."""
    total = F32(0)
    for p in parts:
        total = F32(total + p)
    return total


def slice_sums(values, cuts):
    """Each slice's sum of integer-valued floats (exact in any order below
    2^24, as each CTA's shuffles and barrier sum them), then the cluster's
    in rank order."""
    return rank_sum(F32(values[a:b].astype(np.float64).sum()) for a, b in cuts)


def packed_keys(key, index):
    """(key, index) as one unsigned 64-bit key in the order of `before`:
    the float's bits folded so that unsigned order is float order (-0 as
    +0), the index below them."""
    bits = (np.asarray(key, F32) + F32(0)).view(np.uint32).astype(np.uint64)
    folded = np.where(bits & np.uint64(0x80000000), ~bits & np.uint64(0xFFFFFFFF),
                      bits | np.uint64(0x80000000))
    return (folded << np.uint64(32)) | np.asarray(index).astype(np.uint64)


# ----------------------------------------------------------- schedule_classes

def x_of(lam, total, used, dsafe, has, cap):
    """min over demanded resources of floor((lam t - used) / d), clipped
    to [0, cap] (tpu_policy.py's x_of), column by column."""
    m = np.full(len(cap), INF)
    for j in np.nonzero(has)[0]:
        m = np.minimum(m, np.floor((F32(lam) * total[:, j] - used[:, j])
                                   / dsafe[j]))
    return np.minimum(np.maximum(m, F32(0)), cap)


def bisect(remaining, total, used, dsafe, has, cap, cuts, levels):
    """The rounds of 2^L - 1 midpoints: heap-ordered midpoints of the next
    L levels, their cluster sums, the walk; every step's midpoint and
    decision are the sequential search's. As in the kernel, 40 // L rounds
    of L levels, then 40 % L rounds of one."""
    lo, hi = F32(0), F32(1)
    if not remaining > 0:                # every sum >= 0 >= remaining
        for _ in range(BISECT_STEPS):
            hi = F32(F32(0.5) * F32(lo + hi))
        return lo, hi
    depths = ([levels] * (BISECT_STEPS // levels)
              + [1] * (BISECT_STEPS % levels))
    for depth in depths:
        nv = 2 ** depth - 1
        mid, lo_h, hi_h = {}, {1: lo}, {1: hi}
        for h in range(1, nv + 1):
            mid[h] = F32(F32(0.5) * F32(lo_h[h] + hi_h[h]))
            lo_h[2 * h], hi_h[2 * h] = lo_h[h], mid[h]
            lo_h[2 * h + 1], hi_h[2 * h + 1] = mid[h], hi_h[h]
        sums = {h: slice_sums(x_of(mid[h], total, used, dsafe, has, cap), cuts)
                for h in mid}
        h = 1
        for _ in range(depth):
            ge = sums[h] >= remaining
            lo, hi = (lo, mid[h]) if ge else (mid[h], hi)
            h = 2 * h + (0 if ge else 1)
    return lo, hi


def merge_ranks(keys, delta, cuts):
    """Each node's place in the global stable order and its cum, from the
    slices alone: local rank plus its rank in every other sorted slice;
    local scan plus the other slices' scans below it."""
    n = len(keys)
    place = np.empty(n, np.int64)
    cum = np.empty(n, F32)
    sorted_keys, scans, orders = [], [], []
    for a, b in cuts:
        order = np.argsort(keys[a:b], kind="stable") + a
        orders.append(order)
        sorted_keys.append(keys[order])
        scans.append(np.cumsum(delta[order], dtype=F32))
    for o, order in enumerate(orders):
        mine = sorted_keys[o]
        at = np.arange(len(order))
        c = scans[o].copy()
        for other in range(len(cuts)):
            if other == o or not len(sorted_keys[other]):
                continue
            below = np.searchsorted(sorted_keys[other], mine, side="left")
            at = at + below
            c = np.where(below > 0,
                         c + scans[other][np.maximum(below - 1, 0)], c)
        place[order] = at
        cum[order] = c.astype(F32)
    return place, cum


def model_schedule_classes(avail, total, alive, demands, counts, prefs,
                           threshold, c, levels):
    n, r = avail.shape
    k = len(counts)
    cuts = slices(n, c)
    thr = F32(threshold)
    perm = tp._commit_order(*(torch.as_tensor(a) for a in (
        avail, total, alive, demands, counts))).numpy()
    avail = avail.copy()
    packed = np.zeros((k, 4 * n + 5), np.int32)
    local, admitted, take_sum = {}, {}, {}

    def fill(cls, countf, pref, out_order, out_take):
        nonlocal avail
        d = demands[cls]
        has = d > 0
        dsafe = np.maximum(d, EPS)
        ratio_tot = np.where(has[None, :], (total + EPS) / dsafe[None, :], INF)
        cap_tot = np.where(alive, np.floor(ratio_tot.min(axis=1)), F32(0))
        upper = min(slice_sums(cap_tot, cuts), UPPER_CLAMP)
        any_feasible = bool((cap_tot >= 1).any())
        fenced = max(F32(countf - upper), F32(0)) if countf > 0 else F32(0)
        target = F32(countf - fenced)
        ratio = np.where(has[None, :], (avail + EPS) / dsafe[None, :], INF)
        cap = np.where(cap_tot >= 1, np.minimum(np.floor(ratio.min(axis=1)),
                                                target), F32(0))
        sum_cap = slice_sums(cap, cuts)
        lt = F32(0)
        if pref >= 0:                      # phase 1, from the node's row
            aq, tq = avail[pref], total[pref]
            used_q = tq - aq
            util = np.where(tq > 0, used_q / np.maximum(tq, EPS), F32(0)).max()
            c_min = np.where(has, np.ceil((thr * tq - used_q) / dsafe), INF).min()
            if util < thr:
                lt = min(min(max(c_min, F32(0)), cap[pref]), target)
            lt = lt if countf > 0 else F32(0)
            avail[pref] = aq - lt * d
            cap[pref] = F32(cap[pref] - lt)
        remaining = F32(target - lt)
        used = total - avail
        lo, hi = bisect(remaining, total, used, dsafe, has, cap, cuts, levels)
        x_lo = x_of(lo, total, used, dsafe, has, cap)
        delta = np.maximum(x_of(hi, total, used, dsafe, has, cap) - x_lo,
                           F32(0))
        util_after = np.where(total > 0, (used + x_lo[:, None] * d[None, :])
                              / np.maximum(total, EPS), F32(0)).max(axis=1)
        deficit = max(F32(remaining - slice_sums(x_lo, cuts)), F32(0))
        place, cum = merge_ranks(packed_keys(util_after, np.arange(n)), delta,
                                 cuts)
        extra = np.minimum(np.maximum(deficit - (cum - delta), F32(0)), delta)
        take = x_lo + extra
        out_order[place] = np.arange(n)
        out_take[place] = take.astype(np.int32)
        avail = avail - take[:, None] * d[None, :]
        return (lt, any_feasible, fenced, min(target, sum_cap), upper,
                slice_sums(take, cuts))

    for j, cls in enumerate(perm):
        row = packed[cls]
        lt, feas, fenced, adm, upper, took = fill(
            cls, F32(counts[cls]), int(prefs[cls]), row[5:5 + n],
            row[5 + n:5 + 2 * n])
        row[:5] = [int(lt), int(feas), int(fenced), int(adm), int(upper)]
        local[j], admitted[j], take_sum[j] = lt, adm, took
    residual = {j: max(F32(admitted[j] - min(F32(local[j] + take_sum[j]),
                                             admitted[j])), F32(0))
                for j in range(k)}
    if sum(residual.values()) > 0:          # the residual pass
        for j, cls in enumerate(perm):
            row = packed[cls]
            fill(cls, residual[j], -1, row[5 + 2 * n:5 + 3 * n],
                 row[5 + 3 * n:])
    return packed, avail


_PLAIN_CLASSES = {}


def plain_classes(case):
    if case.name not in _PLAIN_CLASSES:
        packed, avail = tp.schedule_classes_plain(*(torch.as_tensor(a) for a in (
            case.avail, case.total, case.alive, case.demands, case.counts,
            case.prefs)), 0.5)
        _PLAIN_CLASSES[case.name] = (packed.numpy(), avail.numpy())
    return _PLAIN_CLASSES[case.name]


@pytest.mark.parametrize("c", sorted(LEVELS))
@pytest.mark.parametrize("name", wl.CLASS_EDGE_NAMES)
def test_cluster_fill_equals_plain(name, c):
    """Slices, rank-ordered sums, multi-midpoint rounds and merge-path
    ranks give the plain version's packed rows and new availability."""
    case = wl.class_edge_case(name)
    want, want_avail = plain_classes(case)
    got, got_avail = model_schedule_classes(
        case.avail, case.total, case.alive, case.demands, case.counts,
        case.prefs, 0.5, c, LEVELS[c])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_avail, want_avail)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_cluster_fill_at_the_benchmark_shape(levels):
    """10,000 nodes x 4, 8 classes, 1M tasks (bench.py's), 16 slices, each
    number of bisection levels a round the kernel takes."""
    w = wl.workload(np.random.RandomState(42))
    prefs = np.full(len(w.counts), -1, np.int32)
    case = wl.ClassCase("bench", w.avail, w.total, w.alive, w.demands,
                        w.counts.astype(np.int32), prefs)
    want, want_avail = plain_classes(case)
    got, got_avail = model_schedule_classes(
        w.avail, w.total, w.alive, w.demands, case.counts, prefs, 0.5, 16,
        levels)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_avail, want_avail)


def test_merge_ranks_is_the_stable_order():
    """Ties in util_after (and -0 against +0) are broken by index across
    slices as a stable argsort breaks them."""
    rng = np.random.RandomState(0)
    key = rng.choice(np.array([0.5, -0.0, 0.0, 0.25, 1.0], F32), 999)
    delta = rng.randint(0, 4, 999).astype(F32)
    want = np.empty(999, np.int64)
    want[np.argsort(key, kind="stable")] = np.arange(999)
    for c in (1, 3, 8, 16):
        place, cum = merge_ranks(packed_keys(key, np.arange(999)), delta,
                                 slices(999, c))
        np.testing.assert_array_equal(place, want)
        np.testing.assert_array_equal(
            cum, np.cumsum(delta[np.argsort(key, kind="stable")])[want])


# ------------------------------------------------------------------ pg_pack

def row_util(avail, total):
    return np.where(total > 0, (total - avail) / np.maximum(total, EPS),
                    F32(0)).max(axis=-1)


def model_pack(avail, total, alive, demands, mode, c):
    """Each bundle: every row's key from its cached util, each slice's
    least, the least of the slices'; only the winner's row changes."""
    n = avail.shape[0]
    cuts = slices(n, c)
    avail = avail.copy()
    util = row_util(avail, total)
    used = np.zeros(n, bool)
    out = []
    for d in demands:
        can = alive.copy()
        for j in np.nonzero(d > 0)[0]:
            can &= avail[:, j] + EPS >= d[j]
        if mode == "pack":
            score = -util
        elif mode == "spread":
            score = util + np.where(used, SPREAD_PENALTY, F32(0))
        else:
            score = util
            can = can & ~used
        keys = packed_keys(np.where(can, score, INF), np.arange(n))
        least = min((keys[a:b].min() if b > a else EMPTY) for a, b in cuts)
        idx = int(least & np.uint64(0xFFFFFFFF))
        ok = bool(can[idx])
        if ok:
            avail[idx] = avail[idx] - d
            util[idx] = row_util(avail[idx], total[idx])
            used[idx] = True
        out.append(idx if ok else -1)
    return np.array(out + [int(all(i >= 0 for i in out))], np.int32)


_PLAIN_PACKS = {}


@pytest.mark.parametrize("c", sorted(LEVELS))
@pytest.mark.parametrize("name", wl.PACK_EDGE_NAMES)
def test_cluster_argmin_equals_plain(name, c):
    """Cached util, per-slice least keys and single-row updates give the
    plain version's nodes and all-placed flag."""
    case = wl.pack_edge_case(name)
    if name not in _PLAIN_PACKS:
        _PLAIN_PACKS[name] = pk.pack_plain(*(torch.as_tensor(a) for a in (
            case.avail, case.total, case.alive, case.demands)),
            case.mode).numpy()
    got = model_pack(case.avail, case.total, case.alive, case.demands,
                     case.mode, c)
    np.testing.assert_array_equal(got, _PLAIN_PACKS[name])


def test_cluster_argmin_at_the_benchmark_shape():
    """The solver's view of the benchmark: 10,000 nodes padded to 16,384
    rows, its 512 bundles under SPREAD (solve's strategy), 16 slices of
    1,024 rows."""
    mode = "spread"
    w = wl.workload(np.random.RandomState(42))
    n = 16384
    avail, total = np.zeros((n, 4), F32), np.zeros((n, 4), F32)
    alive = np.zeros(n, bool)
    avail[:10000], total[:10000], alive[:10000] = w.avail, w.total, w.alive
    want = pk.pack_plain(*(torch.as_tensor(a) for a in (
        avail, total, alive, w.pg_demands)), mode)
    np.testing.assert_array_equal(
        model_pack(avail, total, alive, w.pg_demands, mode, 16), want.numpy())


# ----------------------------------------------------- the exact quotient

def rn32(x: Fraction) -> F32:
    """x rounded to the nearest float32, ties to even, exactly."""
    near = F32(float(x))                   # within an ulp of it
    best = None
    for cand in (np.nextafter(near, F32(-np.inf)), near,
                 np.nextafter(near, F32(np.inf))):
        err = abs(Fraction(float(cand)) - x)
        even = int(cand.view(np.uint32)) % 2 == 0
        if best is None or err < best[0] or (err == best[0] and even):
            best = (err, cand)
    return best[1]


def fast_quotient(a, d, y):
    """The kernels' q = a y, r = fma(-q, d, a), fma(r, y, q), each rounded
    once, in exact arithmetic."""
    fa, fd, fy = Fraction(float(a)), Fraction(float(d)), Fraction(float(y))
    q = rn32(fa * fy)
    r = rn32(fa - Fraction(float(q)) * fd)
    return rn32(Fraction(float(r)) * fy + Fraction(float(q)))


def divisors(rng, count, top):
    """Random divisors in [EPS, top], with the hard ones: powers of two,
    their neighbours, all-ones significands, the common small demands."""
    exps = rng.uniform(np.log2(1e-6), np.log2(top), count)
    d = (2.0 ** exps).astype(F32)
    hard = []
    for e in range(-19, int(np.log2(top)) + 1, 3):
        p = F32(2.0 ** e)
        hard += [p, np.nextafter(p, F32(0)), np.nextafter(p, F32(np.inf))]
    hard += [F32(v) for v in (0.3, 0.5, 1, 2, 3, 4, 7, 0.1, 1e-6)]
    return np.concatenate([d, np.array(hard, F32)])


def test_fast_quotient_floor_equals_division_in_the_bisection():
    """floor((lam t - used) / d) by the branch-free quotient equals floor
    of IEEE division wherever fast_quotient_ok lets the kernel take it (t
    and used 0 or within 2^+-60, d up to 2^20), and the quotient itself
    is equal wherever it is a normal float."""
    rng = np.random.RandomState(7)
    ds = divisors(rng, 300, 2.0 ** 20)
    checked = 0
    for i in range(2500):
        d = ds[i % len(ds)]
        t = F32(rng.choice([0.0, 2.0 ** rng.uniform(-60, 60),
                            float(rng.choice([1, 4, 8, 64, 256, 384, 1024]))]))
        used = F32(rng.choice([0.0, float(t) * rng.uniform(-0.2, 1.2),
                               2.0 ** rng.uniform(-60, 60)]))
        if used != 0 and not 2.0 ** -60 <= abs(used) <= 2.0 ** 60:
            continue
        lam = F32(rng.choice([0.0, 2.0 ** rng.uniform(-41, 0)]))
        a = F32(F32(lam * t) - used)
        y = F32(F32(1) / d)
        fast, ieee = fast_quotient(a, d, y), F32(a / d)
        assert np.floor(fast) == np.floor(ieee), (a, d)
        if abs(ieee) >= F32(2.0 ** -126):
            assert fast == ieee, (a, d)
        checked += 1
    assert checked > 2000


def test_fast_quotient_equals_division_for_util():
    """(t - a') / max(t, EPS) by the branch-free quotient equals IEEE
    division over util_quotient's guard: max(t, EPS) up to 2^60, the
    dividend 0 or within 2^+-60."""
    rng = np.random.RandomState(8)
    for i in range(2500):
        t = F32(2.0 ** rng.uniform(-20, 60)) if i % 3 else F32(
            rng.choice([1, 4, 8, 64, 256, 384, 1024]))
        x = F32(float(t) * rng.uniform(-1.5, 1.5)) if i % 5 else F32(
            2.0 ** rng.uniform(-60, 60))
        if x != 0 and not 2.0 ** -60 <= abs(x) <= 2.0 ** 60:
            continue
        dd = max(t, EPS)
        y = F32(F32(1) / dd)
        assert fast_quotient(x, dd, y) == F32(x / dd), (x, t)
