"""The launch-shape rule of the cluster kernels K2 - K5, K3c, K7 and K8 -
K13 (open_simulator_torch/ops/cluster.py), as plain Python: the card's
occupancy answer and the library's shared-memory size are models passed in,
so nothing here needs a card. The tables' axes are the ones the encoder pads
to, and tests/test_torch_cuda.py holds `smem_model`, `rounds_smem_model`,
`k3c_smem_model`, `k7_smem_model`, `k1_smem_model` and `k14_smem_model`
against the library's own schedule_batch_smem / group_serial_smem /
schedule_wave_smem / affinity_wave_smem / wave_rounds_smem /
affinity_rounds_smem / wave_sharded_smem / affinity_sharded_smem /
affinity_sharded_tail_smem / batch_sharded_smem / gs_sharded_smem /
aggregate_commit_smem / explain_smem / feasibility_smem /
commit_sharded_smem on the card."""

import functools

import pytest

from open_simulator_torch.ops import cluster

# clusters of C CTAs (one CTA an SM at these shapes) resident at once on a
# card whose SMs sit in processing clusters of these sizes (132 SMs), and on
# one whose largest holds 12 SMs (no cluster of 16)
MODELS = {"gpc_18_16": (18, 18, 18, 18, 16, 16, 14, 14), "gpc_12": (12,) * 11}
NS = (1, 100, 1_024, 2_048, 5_120, 10_240, 100_352)

ROW_WORDS = {"k2": 6, "k2_ext": 7, "k4": 7}  # f32 / i32 rows a node (and a u8 row)
KEYS = {"k2": 9, "k2_ext": 11, "k4": 9}      # round 1's keys
MARKS_FUSED_MAX = 64                          # csrc/cluster.cuh
# K3 and K5 (csrc/wave.cu, csrc/affinity_wave.cu, csrc/wave_cluster.cuh)
WAVE_B = 64         # the deepest table (ops/kernels.py WAVE_BLOCK)
RX_WORDS = 256      # a round slot's words: a radix pass's histogram
RX_SCRATCH = 65 * 16  # the rounds' warp words, (MAX_SLOTS + 1) * warps
K_EP_MAX = 2048     # K5's candidate keys
CTX_BYTES = 9552    # K5's term slots (affinity.cuh Ctx, padded to 16 bytes)
K5_KEYS = 23        # K5's round 1 keys
K5_LIVE_ROWS = 8    # K5's live rows [Sd + A + B + Ca + Cw + 1] of a typical batch
# K11's bound (csrc/affinity_rounds.cu K11_SMEM_MAX): its CTAs hold the term
# slots in static shared memory too
K11_SMEM_MAX = cluster.SMEM_MAX - 8_192
# K8's, K9's, K12's and K13's bound (csrc/wave_sharded.cu K8_SMEM_MAX,
# csrc/affinity_sharded.cu K9_SMEM_MAX, csrc/batch_sharded.cu K12_SMEM_MAX,
# csrc/group_serial_sharded.cu K13_SMEM_MAX): the term slots or PodCtx and
# the stage's StageShared in static shared memory
K8_SMEM_MAX = K9_SMEM_MAX = K12_SMEM_MAX = K13_SMEM_MAX = cluster.SMEM_MAX - 16_384
SMEM_MAX_OF = {"k10": cluster.SMEM_MAX, "k11": K11_SMEM_MAX, "k8": K8_SMEM_MAX,
               "k8_tail": K8_SMEM_MAX, "k9": K9_SMEM_MAX, "k9_tail": K9_SMEM_MAX,
               "k12": K12_SMEM_MAX, "k13": K13_SMEM_MAX}
# K7's bound (csrc/explain.cu K7_SMEM_MAX): PodCtx and StageShared in
# static shared memory
K7_SMEM_MAX = cluster.SMEM_MAX - 16_384
K7_HEAD = 10    # round B's maxima and flag (csrc/explain.cu K7_HEAD)
# K1's bound (csrc/feasibility.cu K1_SMEM_MAX) and its passes' nodes
# (K1_PASS: one a thread; K1_PASS_EXT: five warps a role)
K1_SMEM_MAX = cluster.SMEM_MAX - 16_384
K1_PASS, K1_PASS_EXT = 512, 160
K14_MIN_CHUNK = 32  # ops/kernels.py: K14's rows keep a warp's nodes a CTA
PART_HEAD = 11  # K12's partial vector head (csrc/batch_sharded.cu)
GS_HEAD = 9     # K13's (csrc/group_serial_sharded.cu Q_HEAD)


def wave_smem_model(kernel: str, N: int, C: int, Z: int, D1: int) -> int:
    """K3's (rows: the table [chunk, B+1] and 8 words a node; the round
    slots [2][C][RX_WORDS]) and K5's (the candidate keys and ranks, the term
    slots, warp words, a histogram, the slots [2][C][W] and fin [W], the zone
    partials and sums; then the node rows, 11 words and the table a node,
    and the live rows, each on chip while they fit) dynamic shared memory."""
    chunk = -(-N // C)
    if kernel in ("k3", "k3_ext"):
        rows, rounds = 4 * chunk * (WAVE_B + 1 + 8), 4 * 2 * C * RX_WORDS
        return (rows if rows + rounds <= cluster.SMEM_MAX else 0) + rounds
    W, Z4 = max(RX_WORDS, K5_KEYS + Z), (Z + 3) & ~3
    fixed = 12 * K_EP_MAX + CTX_BYTES + 4 * (RX_SCRATCH + 256 + 2 * C * W + W + 2 * Z4)
    rows, live = 4 * chunk * (WAVE_B + 11), 4 * K5_LIVE_ROWS * D1
    rows_on = fixed + rows <= cluster.SMEM_MAX
    live_on = rows_on and fixed + rows + live <= cluster.SMEM_MAX
    return fixed + (rows if rows_on else 0) + (live if live_on else 0)


def rounds_smem_model(kernel: str, C: int, Cw: int = 0, Z: int = 2, Ss: int = 2,
                      Sd: int = 0) -> int:
    """A CTA's dynamic shared memory in K8's - K13's stages: the round
    slots [2][C][W], W a radix histogram's words (K8's block stages and its
    tail, K10's), and for
    K11 at least the front's row: the stacked vector of 18 + 2 Cw maxima,
    four flags and the Z zone sums), then K11's row partials [W]. K9's
    block stages: W the stacked vector (18 + 2 Cw), then the CTA's maxima
    [W]; K9's tail: the candidate keys (u64), ranks and domains (K_EP_MAX
    each), then W a histogram's words or round 1's 4 + Z, fin [W] and
    round 1's row [4 + Z]; K12's stages: W the front's row (11 maxima and
    the Z zone sums) or the sa stage's Ss counts, fin and the CTA's row [W]
    each; K13's stages: W the DoNotSchedule minima (Sd), the front's row (9
    maxima and the Z zone sums) or the sa stage's Ss counts, fin and the
    CTA's row [W] each. Nothing grows with the block's nodes or the table's
    depth."""
    if kernel in ("k10", "k8", "k8_tail"):
        return 4 * 2 * C * RX_WORDS
    if kernel == "k13":
        W = max(GS_HEAD + Z, Sd, Ss)
        return 4 * (2 * C * W + 2 * W)
    if kernel == "k9":
        W = 18 + 2 * Cw
        return 4 * (2 * C * W + W)
    if kernel == "k9_tail":
        W = max(RX_WORDS, 4 + Z)
        return 16 * K_EP_MAX + 4 * (2 * C * W + W + 4 + Z)
    if kernel == "k12":
        W = max(PART_HEAD + Z, Ss)
        return 4 * (2 * C * W + 2 * W)
    W = max(RX_WORDS, 18 + 2 * Cw + 4 + Z)
    return 4 * (2 * C * W + W)


def smem_model(kernel: str, N: int, C: int, Ss: int, Z: int, D1: int) -> int:
    """A CTA's dynamic shared memory as csrc/cluster.cuh lays it out: its
    per-node rows when they fit SMEM_MAX with the rest, then two sets of
    fused marks, the round slots [2][C][W], fin [W] and the zone sums [Z]
    (K3 and K5: wave_smem_model)."""
    if kernel in ("k3", "k3_ext", "k5"):
        return wave_smem_model(kernel, N, C, Z, D1)
    chunk = -(-N // C)
    rows = 4 * ROW_WORDS[kernel] * chunk + ((chunk + 3) & ~3)
    marks = min(Ss * ((D1 + 31) // 32), MARKS_FUSED_MAX)
    W = KEYS[kernel] + Z + marks
    rounds = 8 * marks + 4 * (2 * C * W + W + Z)
    return (rows if rows + rounds <= cluster.SMEM_MAX else 0) + rounds


@functools.lru_cache(maxsize=None)
def encoder_axes():
    """(ScheduleAnyway slots, zone axis, domains besides the hostnames) of
    the encoder's padded tables for a batch whose pods spread ScheduleAnyway
    on hostname and zone at once: the widest domain axis a batch has."""
    from open_simulator_torch.simulator.encode import pad_encoder_axes
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_cluster, synth_pod

    n = 300
    nodes, pods = synth_cluster(n, 20, hard_predicates=True)
    sim = Simulator(nodes, device="cpu")
    for i in range(4):
        pod = synth_pod(len(pods) + i, labels={"app": "sa2"})
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": key, "whenUnsatisfiable": "ScheduleAnyway",
            "labelSelector": {"matchLabels": {"app": "sa2"}}}
            for key in ("kubernetes.io/hostname", "topology.kubernetes.io/zone")]
        pods.append(pod)
    raw = sim.encode_batch_raw(pods)
    bt = pad_encoder_axes(raw)
    return bt.sa_t.shape[1], bt.n_zones, raw.seed_counter.shape[1] - 1 - n


def padded_d1(N: int) -> int:
    """The encoder's domain axis (sentinel included) for N hostnames."""
    from open_simulator_torch.simulator.encode import _bucket

    return _bucket(N + encoder_axes()[2]) + 1


def _occupancy(model):
    def occ(C, smem):
        assert smem <= cluster.SMEM_MAX  # never asked for a shape that cannot launch
        return sum(g // C for g in MODELS[model])
    return occ


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kernel", ["k2", "k2_ext", "k3", "k3_ext", "k4", "k5"])
@pytest.mark.parametrize("S", [1, 8, 32])
@pytest.mark.parametrize("N", NS + (4_000_000,))
def test_cluster_shape(N, S, kernel, model):
    Ss, Z, _ = encoder_axes()
    assert Ss >= 2 and Z >= 2
    D1 = padded_d1(N)
    assert D1 > N + 1  # padded past the hostnames
    smem_of = lambda C: smem_model(kernel, N, C, Ss, Z, D1)  # noqa: E731
    occ = _occupancy(model)
    # every size fits: rows that do not fit a CTA's shared memory go to scratch
    assert all(smem_of(C) <= cluster.SMEM_MAX for C in cluster.SIZES)
    fits = [C for C in cluster.SIZES if occ(C, smem_of(C))]
    shape = cluster.choose(N, S, smem_of, occ)
    C = shape.C
    # the node axis is cut as documented: CTA r owns [r * chunk, (r + 1) * chunk)
    assert C in fits and shape.threads == cluster.THREADS
    assert shape.chunk == -(-N // C) and (C - 1) * shape.chunk < N <= C * shape.chunk
    assert shape.nodes_per_thread == -(-shape.chunk // shape.threads)
    assert shape.smem == smem_of(C) <= cluster.SMEM_MAX
    # the card's answer bounds the shape: never a cluster it cannot hold
    assert 1 <= shape.occupancy == occ(C, shape.smem)
    assert shape.resident == (shape.occupancy >= S)
    resident = [c for c in fits if occ(c, smem_of(c)) >= S]
    if resident:  # all lanes resident where possible, then the fewest nodes a thread
        assert shape.resident
        best = min(cluster.nodes_per_thread(N, c) for c in resident)
        assert shape.nodes_per_thread == best
        assert C == min(c for c in resident if cluster.nodes_per_thread(N, c) == best)
    else:
        waves = lambda c: -(-S // occ(c, smem_of(c))) * cluster.nodes_per_thread(N, c)  # noqa: E731
        assert waves(C) == min(waves(c) for c in fits)
    if S == 1 and N <= 8 * 1_024 and model == "gpc_18_16":
        # one lane: the smallest cluster whose threads hold one node each
        assert shape.nodes_per_thread == 1 and (C == 1 or -(-N // (C // 2)) > shape.threads)
    if N == 5_120 and S == 1:
        assert C > 1
    if N == 100_352 and model == "gpc_18_16" and S == 1:
        # bench.py's node count with hostname and zone ScheduleAnyway terms:
        # clusters of 16, with every per-node row on chip but K3's and K5's
        # (their table rows of 65 entries a node)
        assert C == 16
        if kernel in ROW_WORDS:
            assert shape.smem > 4 * ROW_WORDS[kernel] * shape.chunk
        else:
            assert shape.smem < 4 * 8 * shape.chunk
    if kernel in ("k3", "k3_ext", "k5") and N <= 5_120 and S == 1 and model == "gpc_18_16":
        # a lane's table and rows on chip up to the engine's 5,120 nodes
        assert shape.smem >= 4 * (WAVE_B + 1) * shape.chunk
    if N == 4_000_000:  # far past the chip: the rows live in scratch
        assert shape.smem < shape.chunk


def test_no_resident_cluster_raises():
    with pytest.raises(ValueError, match="no cluster shape fits"):
        cluster.choose(5_120, 1, lambda C: smem_model("k2", 5_120, C, 2, 4, 8_193),
                       lambda C, smem: 0)


def test_oversized_shape_raises():
    """A shape whose shared memory exceeds SMEM_MAX at every C is never
    asked of the card."""
    def occ(C, smem):
        raise AssertionError("occupancy asked for a shape that cannot launch")

    with pytest.raises(ValueError, match="no cluster shape fits"):
        cluster.choose(5_120, 1, lambda C: cluster.SMEM_MAX + 4, occ)


# K10's and K11's blocks: a rank's NL nodes (bench.py's mesh8_1m on 2 ranks
# is 50,176; mesh8_10m's is about 500,000 on 2 ranks)
ROUND_NLS = (1_024, 2_560, 5_120, 50_176, 500_000)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kernel", ["k10", "k11", "k8", "k8_tail", "k9", "k9_tail", "k12",
                                    "k13"])
@pytest.mark.parametrize("B", [8, 16, 64])
@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("NL", ROUND_NLS)
def test_round_stage_shape(NL, R, B, kernel, model):
    """Every stage of K10 / K11 / K13, K8's and K9's setup, front and table
    and K12's stages over a rank's block, and K8's and K9's tails over the
    mesh's N = NL * R nodes, take the rule's shape: one cluster, the candidate with the
    fewest nodes a thread (ties to the smaller C), never refused (no N, NL,
    B or D+1 is), more than one CTA at every block of 1,024 nodes or more,
    and the same shape at every table depth B (the stages' shared memory
    holds no table)."""
    Ss, Z, _ = encoder_axes()
    n = NL * R if kernel in ("k8_tail", "k9_tail") else NL
    smem_of = lambda C: rounds_smem_model(kernel, C, Cw=2, Z=Z, Ss=Ss, Sd=2)  # noqa: E731
    smem_max = SMEM_MAX_OF[kernel]
    occ = _occupancy(model)
    assert all(smem_of(C) <= smem_max for C in cluster.SIZES)
    shape = cluster.choose(n, 1, smem_of, occ, smem_max=smem_max)
    fits = [C for C in cluster.SIZES if occ(C, smem_of(C))]
    best = min(cluster.nodes_per_thread(n, c) for c in fits)
    assert shape.nodes_per_thread == best
    assert shape.C == min(c for c in fits if cluster.nodes_per_thread(n, c) == best)
    assert shape.smem == smem_of(shape.C) and shape.resident and shape.C > 1
    assert shape.chunk == -(-n // shape.C)
    if n >= 8_192:  # mesh8_1m's and mesh8_10m's blocks: the largest cluster the card holds
        assert shape.C == (16 if model == "gpc_18_16" else 8)
    if n == 1_024:
        assert shape.C == 2 and shape.nodes_per_thread == 1
    if kernel in ("k8_tail", "k9_tail") and n == 5_120 and model == "gpc_18_16":
        # the affinity cluster's tail on two ranks: clusters of 16, one node a thread
        assert shape.C == 16 and shape.nodes_per_thread == 1
    if kernel == "k13" and NL == 2_560 and model == "gpc_18_16":
        # spread's block on two ranks: clusters of 8, one node a thread
        assert shape.C == 8 and shape.nodes_per_thread == 1
    assert shape == cluster.choose(n * R // R, 1, smem_of, occ, smem_max=smem_max)


@pytest.mark.parametrize("kernel", ["k10", "k11"])
def test_round_stage_smem_grows_with_the_rounds_only(kernel):
    """K11's slot widens with the zone axis only past a histogram's words
    (a smaller cluster still fits at 2,000 zones); K10's is a histogram's."""
    assert rounds_smem_model(kernel, 16) == (32_768 if kernel == "k10" else 33_792)
    if kernel == "k11":
        assert rounds_smem_model("k11", 16, Cw=64, Z=200) > rounds_smem_model("k11", 16)
        smem_of = lambda C: rounds_smem_model("k11", C, Cw=64, Z=2_000)  # noqa: E731
        shape = cluster.choose(50_176, 1, smem_of, _occupancy("gpc_18_16"),
                               smem_max=K11_SMEM_MAX)
        assert shape.C == 8 and smem_of(16) > K11_SMEM_MAX


@pytest.mark.parametrize("kernel", ["k8", "k8_tail", "k13"])
def test_scan_and_epoch_stage_smem_grows_with_the_rounds_only(kernel):
    """K8's block stages and tail hold a radix histogram's round slots, the
    same at every block, node count and table depth; K13's slot widens with
    the zone axis (and the DoNotSchedule and ScheduleAnyway slots) only, so
    that a smaller cluster still fits at 2,000 zones, and a shape that fits
    at no cluster size raises."""
    occ = _occupancy("gpc_18_16")
    if kernel != "k13":
        assert rounds_smem_model(kernel, 16) == 32_768
        for n in (128, 2_048, 10_240):
            shape = cluster.choose(n, 1, lambda C: rounds_smem_model(kernel, C), occ,
                                   smem_max=K8_SMEM_MAX)
            assert shape.smem == 4 * 2 * shape.C * RX_WORDS
        assert cluster.choose(128, 1, lambda C: rounds_smem_model(kernel, C), occ,
                              smem_max=K8_SMEM_MAX).C == 1  # overflow_waves: one CTA
        return
    assert rounds_smem_model("k13", 16) == 4 * (2 * 16 * 11 + 2 * 11)
    assert rounds_smem_model("k13", 16, Z=200) > rounds_smem_model("k13", 16)
    assert rounds_smem_model("k13", 16, Sd=40) == rounds_smem_model("k13", 16, Z=31)
    smem_of = lambda C: rounds_smem_model("k13", C, Z=2_000)  # noqa: E731
    shape = cluster.choose(2_560, 1, smem_of, occ, smem_max=K13_SMEM_MAX)
    assert shape.C == 8 and smem_of(16) > K13_SMEM_MAX
    with pytest.raises(ValueError, match="no cluster shape fits"):
        cluster.choose(2_560, 1, lambda C: rounds_smem_model("k13", C, Z=20_000), occ,
                       smem_max=K13_SMEM_MAX)


# ---- K3c and K7: one cluster a lane (csrc/aggregate_commit.cu) and one
# cluster over N (csrc/explain.cu), their shapes cached per their inputs


def k3c_smem_model() -> int:
    """K3c's dynamic shared memory: none at any C (its per-topology sums
    live in global scratch; a CTA's static shared memory holds a lane's
    view)."""
    return 0


def k7_smem_model(C: int, Z: int, Ss: int) -> int:
    """K7's dynamic shared memory: the round slots [2][C][W], fin [W], the
    CTA's row [W] and the zone sums [Z], W round B's row (the 10 maxima and
    flag and the Z zone sums) or round C's Ss counts."""
    W = max(K7_HEAD + Z, Ss)
    return 4 * (2 * C * W + 2 * W + Z)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kernel,S", [("k3c", 1), ("k3c", 8), ("k3c", 32), ("k7", 1)])
@pytest.mark.parametrize("N", NS)
def test_commit_and_explain_shape(N, S, kernel, model):
    """K3c (one lane or S lanes) and K7 (one launch: S = 1) take the rule's
    shape: every size fits at the encoder's axes, the fewest nodes a thread
    among the resident candidates (ties to the smaller C), the shared
    memory of the library's formula, one node a thread up to 8,192 nodes for
    one lane, and clusters of 16 at the engine's 5,120 nodes."""
    Ss, Z, _ = encoder_axes()
    smem_of = ((lambda C: k3c_smem_model()) if kernel == "k3c"  # noqa: E731
               else (lambda C: k7_smem_model(C, Z, Ss)))
    smem_max = cluster.SMEM_MAX if kernel == "k3c" else K7_SMEM_MAX
    occ = _occupancy(model)
    assert all(smem_of(C) <= smem_max for C in cluster.SIZES)
    shape = cluster.choose(N, S, smem_of, occ, smem_max=smem_max)
    fits = [C for C in cluster.SIZES if occ(C, smem_of(C))]
    resident = [c for c in fits if occ(c, smem_of(c)) >= S]
    assert shape.smem == smem_of(shape.C) and shape.chunk == -(-N // shape.C)
    if resident:
        best = min(cluster.nodes_per_thread(N, c) for c in resident)
        assert shape.resident and shape.nodes_per_thread == best
        assert shape.C == min(c for c in resident if cluster.nodes_per_thread(N, c) == best)
    if kernel == "k7":
        assert shape.smem == 4 * (2 * shape.C * (K7_HEAD + Z) + 2 * (K7_HEAD + Z) + Z)
    else:
        assert shape.smem == 0
    if S == 1 and N <= 8_192 and model == "gpc_18_16":
        assert shape.nodes_per_thread == 1 and (shape.C == 1 or -(-N // (shape.C // 2)) > 512)
    if S == 1 and N == 5_120 and model == "gpc_18_16":
        assert shape.C == 16


def test_explain_smem_grows_with_the_zones_only():
    """K7's slot is round B's row: it widens with the zone axis (or past it
    with the ScheduleAnyway slots), never with N; at 2,000 zones a smaller
    cluster still fits, and a shape that fits at no size raises."""
    assert k7_smem_model(16, 2, 2) == 4 * (2 * 16 * 12 + 2 * 12 + 2)
    assert k7_smem_model(16, 2, 40) == 4 * (2 * 16 * 40 + 2 * 40 + 2)
    occ = _occupancy("gpc_18_16")
    shape = cluster.choose(5_120, 1, lambda C: k7_smem_model(C, 2_000, 2), occ,
                           smem_max=K7_SMEM_MAX)
    assert shape.C == 8 and k7_smem_model(16, 2_000, 2) > K7_SMEM_MAX
    with pytest.raises(ValueError, match="no cluster shape fits"):
        cluster.choose(5_120, 1, lambda C: k7_smem_model(C, 20_000, 2), occ,
                       smem_max=K7_SMEM_MAX)


# ---- K1 and K14: one cluster over N (csrc/feasibility.cu) and one over a
# rank's block (csrc/commit_sharded.cu's rows stage), cached likewise


def k1_smem_model(C: int, Sd: int, R: int, ext: bool) -> int:
    """K1's dynamic shared memory: the prologue round's slots [2][C][W], fin
    [W] and the CTA's row [W] (W: the Sd negated minima and the bootstrap
    flag), a pass's stage bits [pass] (u32), its fit_each bytes [pass, R]
    and with EXT its GPU and storage checks [2][pass] (u8)."""
    W, P = Sd + 1, K1_PASS_EXT if ext else K1_PASS
    return 4 * (2 * C * W + 2 * W) + 4 * P + P * R + (2 * P if ext else 0)


def k14_smem_model() -> int:
    """K14's rows stage: none at any C (its sums live in global scratch)."""
    return 0


@functools.lru_cache(maxsize=None)
def k1_axes():
    """(DoNotSchedule slots, resources) of the encoder's padded tables for
    the spread cluster (zone and hostname DoNotSchedule terms)."""
    from open_simulator_torch.core.types import ResourceTypes
    from open_simulator_torch.simulator.engine import Simulator
    from open_simulator_torch.utils.synth import synth_spread_cluster

    nodes, pods, services = synth_spread_cluster(64, 320)
    sim = Simulator(nodes, device="cpu")
    sim.register_cluster_objects(ResourceTypes(services=services))
    bt = sim.encode_batch(pods)
    return bt.dns_t.shape[1], bt.alloc.shape[1]


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kernel", ["k1", "k1_ext", "k14"])
@pytest.mark.parametrize("N", NS)
def test_feasibility_and_sharded_commit_shape(N, kernel, model):
    """K1 (one launch over N nodes, its EXT build over 3N items: a node's
    three checks on three threads) and K14's rows stage (one launch over a
    block of N nodes) take the rule's shape: every size fits at the
    encoder's axes, the fewest items a thread among the resident candidates
    (K1's ties to the smaller C; K14's, one-shot, to the largest C whose
    CTAs keep K14_MIN_CHUNK nodes each, else the smallest), the shared
    memory of the library's formula, and clusters of 16 at the engine's
    5,120 nodes (K1's EXT build at the extended cluster's 2,048; K14 from
    512 nodes a block)."""
    Sd, R = k1_axes()
    ext = kernel == "k1_ext"
    items = 3 * N if ext else N
    smem_of = ((lambda C: k14_smem_model()) if kernel == "k14"  # noqa: E731
               else (lambda C: k1_smem_model(C, Sd, R, ext)))
    smem_max = cluster.SMEM_MAX if kernel == "k14" else K1_SMEM_MAX
    min_chunk = K14_MIN_CHUNK if kernel == "k14" else 0
    occ = _occupancy(model)
    assert all(smem_of(C) <= smem_max for C in cluster.SIZES)
    shape = cluster.choose(items, 1, smem_of, occ, smem_max=smem_max, min_chunk=min_chunk)
    fits = [C for C in cluster.SIZES if occ(C, smem_of(C))]
    best = min(cluster.nodes_per_thread(items, c) for c in fits)
    tied = [c for c in fits if cluster.nodes_per_thread(items, c) == best]
    assert shape.resident and shape.nodes_per_thread == best
    if kernel == "k14":
        keep = [c for c in tied if -(-items // c) >= K14_MIN_CHUNK]
        assert shape.C == (max(keep) if keep else min(tied))
        if model == "gpc_18_16" and N >= 512:
            assert shape.C == 16
    else:
        assert shape.C == min(tied)
    assert shape.smem == smem_of(shape.C) and shape.chunk == -(-items // shape.C)
    if kernel == "k14":
        assert shape.smem == 0
    else:
        W, P = Sd + 1, K1_PASS_EXT if ext else K1_PASS
        assert shape.smem == 4 * (2 * shape.C * W + 2 * W) + (6 if ext else 4) * P + P * R
    if model == "gpc_18_16" and ((N == 5_120 and not ext) or (N == 2_048 and ext)):
        assert shape.C == 16


@pytest.mark.parametrize("N,want", [(1, 1), (62, 1), (63, 2), (100, 2), (200, 4),
                                    (400, 8), (512, 16), (1_024, 16), (10_240, 16)])
def test_one_shot_ties_go_to_the_most_ctas(N, want):
    """`min_chunk` (K14's rows stage): among the shapes with the fewest
    nodes a thread, the largest C whose CTAs each keep min_chunk nodes, the
    smallest C where none does; a card without clusters of 16 takes the
    largest it holds. Without it the persistent kernels' rule is unchanged
    (ties to the smaller C)."""
    occ = _occupancy("gpc_18_16")
    shape = cluster.choose(N, 1, lambda C: 0, occ, min_chunk=K14_MIN_CHUNK)
    assert shape.C == want
    assert shape.nodes_per_thread == min(cluster.nodes_per_thread(N, c) for c in cluster.SIZES)
    if N <= 512:
        assert cluster.choose(N, 1, lambda C: 0, occ).C == 1
    if N >= 512:
        assert cluster.choose(N, 1, lambda C: 0, _occupancy("gpc_12"),
                              min_chunk=K14_MIN_CHUNK).C == 8


def test_feasibility_smem_grows_with_the_slots_and_resources_only():
    """K1's shared memory widens with the DoNotSchedule slots (the round)
    and the resources (the staged fit_each), never with N; a shape that fits
    at no size raises."""
    assert k1_smem_model(16, 2, 4, False) == 4 * (2 * 16 * 3 + 2 * 3) + 4 * 512 + 512 * 4
    assert k1_smem_model(16, 2, 4, True) == 4 * (2 * 16 * 3 + 2 * 3) + 6 * 160 + 160 * 4
    assert k1_smem_model(1, 64, 4, False) - k1_smem_model(1, 2, 4, False) == 4 * 4 * 62
    occ = _occupancy("gpc_18_16")
    for ext in (False, True):
        with pytest.raises(ValueError, match="no cluster shape fits"):
            cluster.choose(5_120, 1, lambda C, ext=ext: k1_smem_model(C, 2, 1_400, ext), occ,
                           smem_max=K1_SMEM_MAX)


@pytest.mark.parametrize("kernel", ["k3c", "k7", "k1", "k14"])
def test_cached_shape_asks_the_card_once(kernel):
    """`choose_cached` (K3c's, K7's, K1's and K14's shapes) asks for shared memory and
    occupancy on a key's first call only and returns the same shape after;
    another key (another N, lane count, EXT or axis) is chosen anew; a
    refused shape raises and is not kept."""
    cache = {}
    asked = []

    def occ(C, smem):
        asked.append((C, smem))
        return sum(g // C for g in MODELS["gpc_18_16"])

    def smem_of(C):
        return {"k3c": k3c_smem_model, "k14": k14_smem_model,
                "k7": lambda: k7_smem_model(C, 4, 2),
                "k1": lambda: k1_smem_model(C, 2, 4, False)}[kernel]()

    key = (kernel, 0, 5_120, 1)
    first = cluster.choose_cached(cache, key, 5_120, 1, smem_of, occ)
    n = len(asked)
    assert n == len(cluster.SIZES)
    for _ in range(3):
        assert cluster.choose_cached(cache, key, 5_120, 1, smem_of, occ) == first
    assert len(asked) == n
    other = cluster.choose_cached(cache, (kernel, 0, 1_024, 1), 1_024, 1, smem_of, occ)
    assert len(asked) == 2 * n and other.C == 2 and first.C == 16

    def refuse(C, smem):
        return 0

    bad = (kernel, 0, 5_120, 8)
    for _ in range(2):
        with pytest.raises(ValueError, match="no cluster shape fits"):
            cluster.choose_cached(cache, bad, 5_120, 8, smem_of, refuse)
    assert bad not in cache and len(cache) == 2
