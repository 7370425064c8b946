"""The resident cluster image: the PyTorch port against the JAX package.

The image scenarios of tests/test_serve.py, run on both packages from the
same inputs (the port on the CPU, through the plain fan-outs): every
response the port's ResidentImage serves (through delta ingest,
copy-on-write drain overlays and multi-lane dispatch) equals the JAX
image's response and the port's own fresh probe of the final cluster, in
counts and in the f64 utilization sums. The micro-batching service, HTTP
and gRPC tests wait for their port (ROADMAP A10b). The torch counterpart of
the donation check is that no dispatch writes an image table or the cached
base carry in place.
"""

import copy

import numpy as np
import pytest

from fixtures import make_node, make_pod
from open_simulator_torch.serve import ImageDonatedError, ResidentImage, StaleImageError
from open_simulator_tpu.serve import ResidentImage as JaxImage
from test_serve import _trace_events, make_cluster, whatif_pods


def build(pkg, nodes, bound=()):
    nodes, bound = copy.deepcopy(nodes), copy.deepcopy(list(bound))
    if pkg == "jax":
        return JaxImage.try_build(nodes, pods=bound)
    return ResidentImage.try_build(nodes, pods=bound, device="cpu")


def same(a: dict, b: dict) -> None:
    for k in ("scheduled", "total", "unscheduled", "utilization"):
        assert a[k] == b[k], (k, a, b)


def both(nodes, bound, steps):
    """Run `steps(img, pkg)` (a list of responses, fresh probes interleaved)
    on a port and a JAX image of the same cluster; every response of the
    port equals the JAX response at the same place."""
    got = steps(build("torch", nodes, bound), "torch")
    want = steps(build("jax", nodes, bound), "jax")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        same(a, b)
    return got


def test_resident_matches_fresh_encode():
    nodes, bound = make_cluster()
    req = whatif_pods("a", 5)
    out = both(nodes, bound, lambda img, _: [img.session(copy.deepcopy(req)).run(),
                                             img.fresh_probe(req)])
    same(out[0], out[1])
    assert out[0]["path"] == "batched"


def test_request_drain_overlay_parity():
    nodes, bound = make_cluster(10, 8)
    req = whatif_pods("anti", 6, anti_on="svc-0")

    def steps(img, _):
        out = []
        for drains in ([], ["n-0"], ["n-0", "n-1"]):
            out += [img.session(copy.deepcopy(req), drains=drains).run(),
                    img.fresh_probe(req, drains=drains)]
        assert img.n_nodes == 10 and not img.drained
        return out

    out = both(nodes, bound, steps)
    for i in range(0, len(out), 2):
        same(out[i], out[i + 1])


def test_overlarge_cluster_saturates_identically():
    nodes, _ = make_cluster(6, 0)
    req = whatif_pods("big", 9, cpu="6", memory="12Gi")
    out = both(nodes, [], lambda img, _: [img.session(copy.deepcopy(req)).run(),
                                          img.fresh_probe(req)])
    assert out[0]["scheduled"] == 6 and out[0]["unscheduled"] == 3
    same(out[0], out[1])


@pytest.mark.parametrize("seed", [7, 23, 101])
def test_delta_ingest_trace_matches_from_scratch(seed):
    """A seeded sequence of node add / node drain / pod churn batches: the
    port's answers equal the JAX image's, its own fresh probe and a new
    image built over the final state."""
    nodes, bound = make_cluster(8, 5)
    req = whatif_pods("trace", 5, anti_on="churn")

    def steps(img, pkg):
        rng = np.random.default_rng(seed)
        live_counter = [0, 0, 0]
        out = []
        for _ in range(4):
            img.apply_events(_trace_events(rng, nodes, live_counter))
            got = img.session(copy.deepcopy(req)).run()
            same(got, img.fresh_probe(req))
            out.append(got)
        img2 = build(pkg, img.current_nodes(), img.cluster_pods())
        same(img.session(copy.deepcopy(req)).run(), img2.session(copy.deepcopy(req)).run())
        return out

    both(nodes, bound, steps)


def test_pod_churn_refreshes_seeds_without_restage():
    nodes, bound = make_cluster()
    req = whatif_pods("churn", 4)

    def steps(img, _):
        staged = img._tables
        out = img.apply_events([
            {"type": "pod_add", "pod": make_pod("c-1", cpu="1", memory="1Gi",
                                                node_name="n-2")},
            {"type": "pod_delete", "namespace": "default", "name": "bound-0"}])
        assert out["applied"] == 2 and not out["restaged"]
        assert img._tables is staged
        return [img.session(copy.deepcopy(req)).run(), img.fresh_probe(req)]

    out = both(nodes, bound, steps)
    same(out[0], out[1])


def test_node_drain_moves_no_bytes_and_add_restages():
    nodes, bound = make_cluster()
    req = whatif_pods("nodes", 6, cpu="3", memory="6Gi")

    def steps(img, _):
        staged = img._tables
        out = img.apply_events([{"type": "node_drain", "name": "n-3"}])
        assert out["applied"] == 1 and not out["restaged"]
        assert img._tables is staged and img.n_nodes == 11
        out = img.apply_events([
            {"type": "node_add", "node": make_node("n-new", cpu="4", memory="8Gi")}])
        assert out["restaged"] and img.n_nodes == 12
        return [img.session(copy.deepcopy(req)).run(), img.fresh_probe(req)]

    out = both(nodes, bound, steps)
    same(out[0], out[1])


def test_intra_batch_event_ordering():
    nodes, bound = make_cluster(6, 3)
    req = whatif_pods("order", 4)

    def steps(img, _):
        out = img.apply_events([
            {"type": "node_add", "node": make_node("nx", cpu="16", memory="32Gi")},
            {"type": "pod_add", "pod": make_pod("on-nx", cpu="4", memory="4Gi",
                                                node_name="nx")}])
        assert out["applied"] == 2 and out["skipped"] == 0
        res = [img.session(copy.deepcopy(req)).run(), img.fresh_probe(req)]
        out = img.apply_events([
            {"type": "node_add", "node": make_node("ny", cpu="16", memory="32Gi")},
            {"type": "node_drain", "name": "ny"}])
        assert out["applied"] == 2 and "ny" in img.drained
        return res + [img.session(copy.deepcopy(req)).run(), img.fresh_probe(req)]

    out = both(nodes, bound, steps)
    same(out[0], out[1])
    same(out[2], out[3])


def test_unexpressible_event_rebuilds_not_approximates():
    nodes, bound = make_cluster(8, 4)

    def steps(img, _):
        gen = img.generation
        sess = img.session(whatif_pods("stale", 3))
        img.apply_events([{"type": "node_add", "node": make_node(
            "gpu-node", cpu="8", memory="16Gi", extra_resources={"example.com/widget": "4"})}])
        assert img.generation == gen + 1
        with pytest.raises(Exception) as err:
            sess.run()
        assert "generation" in str(err.value)
        sess.ensure_current()
        return [sess.run(), img.fresh_probe(sess.pods)]

    out = both(nodes, bound, steps)
    same(out[0], out[1])


def test_stale_session_raises_the_port_error():
    nodes, bound = make_cluster(8, 4)
    img = build("torch", nodes, bound)
    sess = img.session(whatif_pods("stale", 3))
    img.apply_events([{"type": "node_add", "node": make_node(
        "w", cpu="8", memory="16Gi", extra_resources={"example.com/widget": "4"})}])
    with pytest.raises(StaleImageError):
        sess.run()


def test_multi_lane_dispatch_equals_jax_and_fresh():
    """Heterogeneous requests in one dispatch (both lane kinds, a padding
    lane, drains): each response equals the JAX image's and its own fresh
    probe."""
    nodes, bound = make_cluster(10, 6)
    shapes = [(whatif_pods("m0", 3), ()), (whatif_pods("m1", 5, cpu="2"), ("n-1",)),
              (whatif_pods("m2", 2, anti_on="svc-1"), ()),
              (whatif_pods("m3", 4, memory="2Gi"), ("n-0", "n-2")),
              (whatif_pods("m0", 9), ())]
    mixed = whatif_pods("mx", 2) + whatif_pods("my", 3, cpu="2")
    shapes.append((mixed, ()))

    def steps(img, _):
        sessions = [img.session(copy.deepcopy(p), drains=d) for p, d in shapes]
        out = img.dispatch_sessions(sessions)
        assert {r["lanes"] for r in out} == {len(shapes)}
        return out + [img.fresh_probe(p, drains=d) for p, d in shapes]

    out = both(nodes, bound, steps)
    for i in range(len(shapes)):
        same(out[i], out[len(shapes) + i])


def test_ineligible_requests_gate():
    nodes, bound = make_cluster(8, 3)
    img = build("torch", nodes, bound)
    spread = make_pod("spread-1", cpu="1", memory="1Gi", labels={"app": "sp"})
    spread["spec"]["topologySpreadConstraints"] = [{
        "maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
        "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "sp"}}}]
    assert "topology spread" in img.eligible(img.encode_request([spread]), [spread])
    prebound = make_pod("pre-1", cpu="1", memory="1Gi", node_name="n-0")
    assert img.eligible(img.encode_request([prebound]), [prebound]) == "pre-bound pod"
    plain = whatif_pods("ok", 2)
    assert img.eligible(img.encode_request(plain), plain) is None


def test_image_tables_survive_dispatches():
    nodes, bound = make_cluster()
    img = build("torch", nodes, bound)
    for _ in range(3):
        img.session(whatif_pods("alive", 3)).run()
        img.session(whatif_pods("alive", 3) + whatif_pods("b", 2)).run()
    img.assert_image_alive()


def test_assert_image_alive_catches_in_place_writes():
    """Negative control: a write into an image table, or into the cached
    base carry, is caught."""
    nodes, _ = make_cluster(8, 0)
    img = build("torch", nodes)
    img.session(whatif_pods("w", 3)).run()  # caches the 1-lane base carry
    img.assert_image_alive()
    img._base_carry(1).requested.add_(0.0)
    with pytest.raises(ImageDonatedError):
        img.assert_image_alive()
    img = build("torch", nodes)
    img._tables.alloc.mul_(1.0)
    with pytest.raises(ImageDonatedError):
        img.assert_image_alive()
