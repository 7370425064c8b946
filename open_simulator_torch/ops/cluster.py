"""Launch shapes of the cluster kernels K1 - K5, K3c, K7 and K8 - K14
(csrc/cluster.cuh).

Each lane of K2 (`schedule_batch`), K3 (`schedule_wave`), K4
(`schedule_group_serial`) and K5 (`schedule_affinity_wave`) runs on one
thread-block cluster of C CTAs of THREADS threads; CTA r owns the node
slice [r * chunk, (r + 1) * chunk), chunk = ceil(N / C), and each of its
threads holds ceil(chunk / THREADS) nodes of a pod step, wave iteration or
epoch. `choose` picks C from N, the lane count S and the card's answer to
how many such clusters can be resident at once
(cudaOccupancyMaxActiveClusters), given as a function so that the rule
runs without a card, as is the shared memory of a CTA at each C (`smem_of`:
on the card the library's schedule_batch_smem / schedule_wave_smem /
group_serial_smem / affinity_wave_smem, csrc/schedule.cu `k2_smem_bytes`,
csrc/wave.cu `k3_smem_bytes`, csrc/group_serial.cu `k4_smem_bytes` and
csrc/affinity_wave.cu `k5_smem_bytes`). A CTA's per-node rows are in its
shared memory when they fit SMEM_MAX, else in global scratch, so every N
has a shape. The node mesh's kernels run every stage as one cluster over
a rank's block of NL nodes, its shape the rule's for one lane over NL:
K10 (csrc/wave_rounds.cu, `wave_rounds_smem`), K11's cluster stages
(csrc/affinity_rounds.cu, `affinity_rounds_smem`), K12
(csrc/batch_sharded.cu, `batch_sharded_smem`), K13
(csrc/group_serial_sharded.cu, `gs_sharded_smem`) and the setup, front and
table of K8 and K9 (csrc/wave_sharded.cu `wave_sharded_smem`,
csrc/affinity_sharded.cu `affinity_sharded_smem`); the tails of K8 and K9
(`wave_sharded_smem`, `affinity_sharded_tail_smem`) are one cluster over
the mesh's N nodes. Their shared memory holds the rounds' words only
(K9's tail also its candidate keys), bounded by each kernel's smem_max
(K8, K9, K11, K12, K13); a shape the rule refuses raises. K3c
(csrc/aggregate_commit.cu, one cluster a lane, `aggregate_commit_smem`:
none), K7 (csrc/explain.cu, one cluster over N, `explain_smem`: the
rounds' words, bounded by `explain_smem_max`), K1 (csrc/feasibility.cu,
one cluster over N, its EXT build over 3N items: a node's three checks on
three threads; `feasibility_smem`: the prologue round's words and a pass's
staged bits and fit_each bytes, bounded by `feasibility_smem_max`) and
K14's rows stage (csrc/commit_sharded.cu, one cluster over a rank's
block, `commit_sharded_smem`: none; one-shot, its ties to the largest C
whose CTAs keep a warp's 32 nodes, `min_chunk`) take the rule's shape
too; they run tens to hundreds of times a run, so their shapes are cached
per their inputs (`choose_cached`) and only a shape's first call asks the
card for occupancy. Plain Python: nothing here needs torch or a card.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, NamedTuple

THREADS = 512            # csrc/cluster.cuh CLUSTER_THREADS
SIZES = (1, 2, 4, 8, 16)  # cluster sizes; 16 is the non-portable maximum
# dynamic shared memory a CTA may ask for: 227 KB less room for the
# kernels' static shared memory (csrc/cluster.cuh CLUSTER_SMEM_MAX)
SMEM_MAX = 232_448 - 8_192
# a launch's stats row per lane (csrc/cluster.cuh STATS_WORDS, i64): rounds,
# cluster barriers, pods stepped
STATS_WORDS = 3


class Shape(NamedTuple):
    C: int                 # CTAs of a lane's cluster
    threads: int           # threads of a CTA
    smem: int              # dynamic shared memory bytes of a CTA
    chunk: int             # nodes a CTA owns (the last may own fewer)
    nodes_per_thread: int
    occupancy: int         # clusters of this shape resident at once
    resident: bool         # every lane's cluster resident at once


def chunk_of(N: int, C: int) -> int:
    return -(-N // C)


def nodes_per_thread(N: int, C: int, threads: int = THREADS) -> int:
    return max(1, -(-chunk_of(N, C) // threads))


def choose(N: int, S: int, smem_of: Callable[[int], int],
           occupancy: Callable[[int, int], int], threads: int = THREADS,
           smem_max: int = SMEM_MAX, min_chunk: int = 0) -> Shape:
    """The cluster shape of an S-lane launch over N nodes.

    Every C of SIZES whose shared memory `smem_of(C)` fits `smem_max` (the
    kernel's bound, SMEM_MAX but for K11's) and of
    which the card can hold at least one cluster (`occupancy(C, smem)`) is a
    candidate. A lane is persistent for its whole pod stream, and a pod
    step's time grows with the nodes a thread holds, so the rule takes,
    where some candidate keeps all S clusters resident at once, the
    resident candidate with the fewest nodes per thread; otherwise the
    least waves of resident clusters (ceil(S / occupancy)) times nodes per
    thread; ties go to the smaller C. One lane at N 5,120 takes C 16 (320
    nodes a CTA, one a thread); eight lanes take C 8 where eight clusters
    of 16 do not fit at once. With `min_chunk` (a one-shot launch, whose
    CTAs share its bytes rather than step a pod stream: K14's rows stage)
    ties go instead to the LARGEST C whose CTAs each keep at least
    min_chunk nodes (the smallest C where none does): more SMs move the
    same bytes. Raises ValueError when no C fits."""
    best = None
    for C in SIZES:
        smem = int(smem_of(C))
        if smem > smem_max:
            continue
        occ = int(occupancy(C, smem))
        if occ < 1:
            continue
        npt = nodes_per_thread(N, C, threads)
        small = chunk_of(N, C) < min_chunk
        tie = (small, C if small else -C) if min_chunk else (C,)
        key = (0, npt) + tie if occ >= S else (1, -(-S // occ) * npt) + tie
        if best is None or key < best[0]:
            best = (key, Shape(C, threads, smem, chunk_of(N, C), npt, occ, occ >= S))
    if best is None:
        raise ValueError(f"no cluster shape fits N={N} with {S} lanes: every size of {SIZES} "
                         f"needs more than {smem_max} bytes of shared memory or has no "
                         f"resident cluster")
    return best[1]


def choose_cached(cache: Dict[Hashable, Shape], key: Hashable, N: int, S: int,
                  smem_of: Callable[[int], int], occupancy: Callable[[int, int], int],
                  threads: int = THREADS, smem_max: int = SMEM_MAX,
                  min_chunk: int = 0) -> Shape:
    """`choose` once per `key` of `cache`: later calls with the same key
    return the first call's shape and ask neither `smem_of` nor `occupancy`
    again. The key holds every input the shape depends on (the device, N, S
    and the shared-memory arguments; `min_chunk` is the kernel's own); a
    refused shape raises and is not kept."""
    shape = cache.get(key)
    if shape is None:
        shape = cache[key] = choose(N, S, smem_of, occupancy, threads, smem_max, min_chunk)
    return shape
