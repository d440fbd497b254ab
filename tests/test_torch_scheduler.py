"""Port parity of the streamed dispatch and its policy: ``cost_model``'s
flat-transport pricing, ``scheduler``'s plans and decisions, the
executor's entry points, and ``Transport.run(plan=...)``.

Tolerances:
* plans, group slices and fractions, every cost-model function and every
  decision given the same explicit pricing: equal to the reference's
  (exact: the same float expressions in the same order);
* within the port, ``run(plan=)`` is bitwise ``run(layout=)`` for
  ``sequenced`` and ``psum``, exchange and local roundtrip, stacked and per
  bucket, on one worker and on 2 gloo workers (one spawned run);
* against the reference's ``run(plan=)`` (``torch.fft.rfft`` patched to
  XLA's rfft, as in test_torch_engine.py): each group's kept indices
  bitwise, reconstructions within 2e-6 * max|x| per chunk row (fp32 FFTs
  summed in different orders).
"""

import dataclasses
import math
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import REPO, given, settings, st
from repro.comms import bucketing as jb
from repro.comms import calibrate as jcal
from repro.comms import cost_model as jcm
from repro.comms import executor as jex
from repro.comms import scheduler as jsch
from repro.comms import transport as jt
from repro.comms.reducers import ReducerConfig as JRC
from repro.core import compressor as jc
from repro_torch.comms import bucketing as tb
from repro_torch.comms import calibrate as tcal
from repro_torch.comms import cost_model as tcm
from repro_torch.comms import executor as tex
from repro_torch.comms import scheduler as tsch
from repro_torch.comms import transport as tt
from repro_torch.comms.reducers import ReducerConfig as TRC
from repro_torch.core import compressor as tc

LAYOUTS = [(5 * 4096 + 100, 4096 * 4), (9 * 4096, 2 * 4096 * 4), (7 * 4096 + 100, 3 * 4096 * 4),
           (40 * 4096 + 7, 4 * 4096 * 4), (3 * 4096, None)]
GROUPS = [None, 1, 2, 3, 5, 100]


@pytest.mark.parametrize("total,bucket_bytes", LAYOUTS)
def test_build_plan_matches_reference(total, bucket_bytes):
    for n_groups in GROUPS:
        jp = jsch.build_plan(jb.build_layout(total, bucket_bytes), n_groups)
        tp = tsch.build_plan(tb.build_layout(total, bucket_bytes), n_groups)
        assert tp.groups == jp.groups and tp.n_groups == jp.n_groups
        assert tp.group_fractions() == jp.group_fractions()
        for (tlo, thi, tsub), (jlo, jhi, jsub) in zip(tp.group_slices(), jp.group_slices()):
            assert (tlo, thi) == (jlo, jhi)
            assert (tsub.total, tsub.boundaries, tsub.chunk) == (jsub.total, jsub.boundaries,
                                                                 jsub.chunk)
    with pytest.raises(ValueError):
        tsch.StreamPlan(tb.build_layout(9 * 4096, 4096 * 4), ((0, 4), (4, 9)))


@settings(deadline=None, max_examples=60)
@given(n_chunks=st.integers(1, 200), tail=st.integers(0, 4095),
       bucket_chunks=st.integers(1, 9), n_groups=st.integers(1, 30))
def test_build_plan_property_matches_reference(n_chunks, tail, bucket_chunks, n_groups):
    """Any layout and group count: the reference's plan, a partition of the
    buckets in readiness order (no deadline: the first example imports)."""
    total = n_chunks * 4096 + tail
    jp = jsch.build_plan(jb.build_layout(total, bucket_chunks * 4096 * 4), n_groups)
    tp = tsch.build_plan(tb.build_layout(total, bucket_chunks * 4096 * 4), n_groups)
    assert tp.groups == jp.groups and tp.group_fractions() == jp.group_fractions()
    assert sum(sub.total for _, _, sub in tp.group_slices()) == total


THR = dict(t_m=300e9, t_f=150e9, t_p=34e9, t_s=100e9)


def test_cost_model_functions_equal_reference():
    jthr, tthr = jcm.Throughputs(**THR), tcm.Throughputs(**THR)
    assert tcm.k_min(6e9, tthr) == jcm.k_min(6e9, jthr)
    assert tcm.k_min(1e12, tthr) == jcm.k_min(1e12, jthr) == float("inf")
    for k in (1.5, 3.0, 30.0):
        assert tcm.is_beneficial(1e8, 6e9, k, tthr) == jcm.is_beneficial(1e8, 6e9, k, jthr)
    assert tcm.compression_cost_s(1e8, tthr) == jcm.compression_cost_s(1e8, jthr)
    assert tcm.saved_comm_s(1e8, 6e9, 3.3) == jcm.saved_comm_s(1e8, 6e9, 3.3)
    for n in (1, 4095, 4096, 10 ** 6):
        assert tcm.dense_spectrum_bits(n) == jcm.dense_spectrum_bits(n)
        assert tcm.dense_time_bits(n, 2048) == jcm.dense_time_bits(n, 2048)
        assert tcm.dense_allreduce_bits(n, 4) == jcm.dense_allreduce_bits(n, 4)
    for mb, bucket in ((4e6, 1 << 20), (1e8, 64 << 20), (1e3, None)):
        assert tcm.bucket_count(mb, bucket) == jcm.bucket_count(mb, bucket)
    for n in (1, 2, 7):
        assert tcm.overlap_fraction(n) == jcm.overlap_fraction(n)
    sizes = (3 * 4096, 3 * 4096, 4096 + 100)
    wb = jc.FFTCompressor(jc.FFTCompressorConfig()).wire_bits
    twb = tc.FFTCompressor(tc.FFTCompressorConfig()).wire_bits
    for transport in ("allgather", "sequenced", "psum"):
        for stacked in (True, False):
            assert (tcm.bucketed_payload_bits(twb, sizes, transport, stacked=stacked)
                    == jcm.bucketed_payload_bits(wb, sizes, transport, stacked=stacked))
        for mode in ("modeled", "runtime"):
            for workers in (1, 2, 8):
                kw = dict(mode=mode, n_elems=10 ** 6)
                assert (tcm.transport_wire_bits(transport, 1e6, workers, **kw)
                        == jcm.transport_wire_bits(transport, 1e6, workers, **kw))
                for stacked, n_buckets in ((True, 4), (False, 4), (False, 1)):
                    kw2 = dict(workers=workers, transport=transport, n_buckets=n_buckets,
                               stacked=stacked, alpha_s=2e-5, wire_mode=mode)
                    assert (dataclasses.asdict(tcm.exchange_time_s(4e6, 1e6, 6e9, tthr, **kw2))
                            == dataclasses.asdict(jcm.exchange_time_s(4e6, 1e6, 6e9, jthr,
                                                                      **kw2)))
                for backprop in (0.0, 1e-3, 1.0):
                    kw3 = dict(workers=workers, transport=transport, alpha_s=2e-5,
                               group_fractions=(0.5, 0.25, 0.25), backprop_s=backprop,
                               wire_mode=mode)
                    t = tcm.streamed_exchange_time_s(4e6, 1e6, 6e9, tthr, **kw3)
                    j = jcm.streamed_exchange_time_s(4e6, 1e6, 6e9, jthr, **kw3)
                    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_cost_model_defaults_hold_no_tpu_figure():
    assert not any("tpu" in name for name in tcm.NETWORKS)
    assert tcm.DEFAULT_NETWORK in tcm.NETWORKS
    assert tcm.H100 != jcm.TPU_V5E and tcm.BACKPROP_FLOPS_PER_S != jcm.BACKPROP_FLOPS_PER_S
    assert not hasattr(tcm, "TPU_V5E")
    # the two-level defaults are an H100 SXM's NVLink and a 400 Gb/s fabric
    assert tcm.NVLINK_NETWORK in tcm.NETWORKS and tcm.FABRIC_NETWORK in tcm.NETWORKS
    plan = tcm.two_level_exchange_time_s(4e6, 1e6, nodes=2, local=4)
    ref = jcm.two_level_exchange_time_s(4e6, 1e6, nodes=2, local=4, thr=tcm.H100,
                                        t_comm_intra=tcm.NETWORKS[tcm.NVLINK_NETWORK],
                                        t_comm_inter=tcm.NETWORKS[tcm.FABRIC_NETWORK])
    assert dataclasses.asdict(plan) == dataclasses.asdict(ref)
    assert plan.exchange_s != jcm.two_level_exchange_time_s(4e6, 1e6, nodes=2,
                                                            local=4).exchange_s
    with pytest.raises(ValueError, match="topology"):
        tcm.transport_wire_bits("hierarchical", 1e6, 4)


def test_two_level_pricing_equals_reference():
    """Given the same explicit link rates and throughputs, every two-level
    pricing function returns the reference's floats."""
    tthr, jthr = tcm.Throughputs(**THR), jcm.Throughputs(**THR)
    for nodes, local in ((1, 1), (1, 4), (2, 1), (2, 2), (2, 4), (8, 8)):
        for mode in ("modeled", "runtime"):
            kw = dict(mode=mode, n_elems=10 ** 6 + 3, chunk=4096)
            assert (dataclasses.asdict(tcm.two_level_wire_bits(2e5, nodes, local, **kw))
                    == dataclasses.asdict(jcm.two_level_wire_bits(2e5, nodes, local, **kw)))
            workers = nodes * local
            for transport in ("hierarchical", "reduce_scatter"):
                kw2 = dict(kw, topology=(nodes, local))
                assert (tcm.transport_wire_bits(transport, 2e5, workers, **kw2)
                        == jcm.transport_wire_bits(transport, 2e5, workers, **kw2))
                for stacked in (True, False):
                    kw3 = dict(workers=workers, transport=transport, n_buckets=4,
                               stacked=stacked, alpha_s=2e-5, wire_mode=mode,
                               topology=(nodes, local))
                    assert (dataclasses.asdict(tcm.exchange_time_s(4e6, 1e6, 6e9, tthr, **kw3))
                            == dataclasses.asdict(jcm.exchange_time_s(4e6, 1e6, 6e9, jthr,
                                                                      **kw3)))
                kw4 = dict(workers=workers, transport=transport, alpha_s=2e-5,
                           group_fractions=(0.5, 0.5), backprop_s=1e-3, wire_mode=mode,
                           topology=(nodes, local))
                assert (dataclasses.asdict(tcm.streamed_exchange_time_s(4e6, 1e6, 6e9, tthr,
                                                                        **kw4))
                        == dataclasses.asdict(jcm.streamed_exchange_time_s(4e6, 1e6, 6e9,
                                                                           jthr, **kw4)))
            kw5 = dict(nodes=nodes, local=local, t_comm_intra=4e11, t_comm_inter=1.2e10,
                       alpha_intra_s=5e-6, alpha_inter_s=3e-5, wire_mode=mode)
            assert (dataclasses.asdict(tcm.two_level_exchange_time_s(4e6, 1e6, thr=tthr, **kw5))
                    == dataclasses.asdict(jcm.two_level_exchange_time_s(4e6, 1e6, thr=jthr,
                                                                        **kw5)))
    with pytest.raises(ValueError, match="multiply"):
        tcm.transport_wire_bits("hierarchical", 1e6, 4, topology=(2, 3))


def _profiles(alpha=3e-5, beta=1 / 9e9, backprop=2e14, gather_alpha=None, per_axis=()):
    """The same measured numbers as a reference and a port CostProfile;
    ``per_axis`` holds (family, alpha, beta, axis) fits of a two-level
    calibration."""
    def fits(cal):
        return ((cal.LinkFit("gather", gather_alpha or alpha, beta),
                 cal.LinkFit("psum", alpha, beta))
                + tuple(cal.LinkFit(f, a, b, axis=ax) for f, a, b, ax in per_axis))

    j = jcal.CostProfile(
        key=jcal.ProfileKey("gpu", (("data", 2),), "none", "any"), fits=fits(jcal),
        throughputs=jcm.Throughputs(**THR), backprop_flops_per_s=backprop)
    t = tcal.CostProfile(
        key=tcal.ProfileKey("cuda", "card", 2, "none", "any"), fits=fits(tcal),
        throughputs=tcm.Throughputs(**THR), backprop_flops_per_s=backprop)
    return j, t


PER_AXIS = (("psum", 4e-6, 1 / 3e11, "local"), ("gather", 5e-6, 1 / 3e11, "local"),
            ("psum", 4e-5, 1 / 1e10, "node"), ("gather", 5e-5, 1 / 1e10, "node"))


@pytest.mark.parametrize("per_axis", [(), PER_AXIS])
@pytest.mark.parametrize("beta", [1 / 1e9, 1 / 4e10, 1 / 4e11])
def test_choose_transport_decides_as_reference(per_axis, beta):
    """A sweep of (nodes, local) topologies and payloads: the same decision
    and the same numbers as the reference, given the same profile."""
    jprof, tprof = _profiles(beta=beta, per_axis=per_axis)
    verdicts = set()
    for nodes, local in ((2, 2), (2, 8), (4, 4), (16, 8), (64, 2)):
        for n_elems, payload in ((10 ** 6, 2e6), (10 ** 8, 1e8), (10 ** 9, 3e8)):
            kw = dict(nodes=nodes, local=local, n_buckets=3, chunk=4096)
            td = tsch.choose_transport(n_elems, payload, profile=tprof, **kw)
            jd = jsch.choose_transport(n_elems, payload, profile=jprof, **kw)
            assert td.to_dict() == jd.to_dict()
            verdicts.add(td.transport)
        red = dict(kind="fft", transport="auto", bucket_bytes=4 * 4096 * 4)
        got = tsch.resolve_transport(TRC(**red), 40 * 4096 + 7, topology=(nodes, local),
                                     profile=tprof)
        want = jsch.resolve_transport(JRC(**red), 40 * 4096 + 7, topology=(nodes, local),
                                      profile=jprof)
        assert got[0] == want[0] and got[1].to_dict() == want[1].to_dict()
    assert verdicts  # the sweep reached a verdict


def test_resolve_transport_degenerate_topologies_resolve_to_psum():
    red = dict(kind="fft", transport="auto", bucket_bytes=4 * 4096 * 4)
    for topology in (None, (1, 1), (1, 8), (8, 1)):
        assert tsch.resolve_transport(TRC(**red), 10 ** 6, topology=topology) == ("psum", None)
    assert tsch.resolve_transport(TRC(kind="dense", transport="auto"), 10 ** 6,
                                  topology=(2, 2)) == ("psum", None)
    assert tsch.resolve_transport(TRC(**dict(red, transport="reduce_scatter")), 10 ** 6,
                                  topology=(2, 2)) == ("reduce_scatter", None)
    name, decision = tsch.resolve_transport(TRC(**red), 10 ** 8, topology=(2, 4))
    assert name == decision.transport and decision.nodes == 2 and decision.local == 4


@pytest.mark.parametrize("transport", ["sequenced", "psum"])
@pytest.mark.parametrize("backprop,alpha", [(1e11, 1e-6), (1e15, 5e-4), (3e12, 2e-5)])
def test_choose_and_resolve_schedule_equal_reference(transport, backprop, alpha):
    jprof, tprof = _profiles(alpha=alpha, backprop=backprop)
    total = 40 * 4096 + 7
    red = dict(kind="fft", transport=transport, bucket_bytes=4 * 4096 * 4, schedule="auto")
    decisions = set()
    for groups in (None, 2, 3):
        for workers, tokens in ((2, 4096), (8, 1 << 16)):
            jname, jdec = jsch.resolve_schedule(JRC(stream_groups=groups, **red), total, tokens,
                                                workers=workers, profile=jprof)
            tname, tdec = tsch.resolve_schedule(TRC(stream_groups=groups, **red), total, tokens,
                                                workers=workers, profile=tprof, overlap=True)
            assert tname == jname and tdec.to_dict() == jdec.to_dict()
            decisions.add(tname)
            # explicit pricing, no profile
            jl, tl = jb.build_layout(total, red["bucket_bytes"]), tb.build_layout(
                total, red["bucket_bytes"])
            kw = dict(workers=workers, transport=transport, backprop_s=backprop * 1e-15,
                      t_comm=7e9, alpha_s=alpha)
            jd = jsch.choose_schedule(jsch.build_plan(jl, groups), 4.0 * total, 3e6,
                                      thr=jcm.Throughputs(**THR), **kw)
            td = tsch.choose_schedule(tsch.build_plan(tl, groups), 4.0 * total, 3e6,
                                      thr=tcm.Throughputs(**THR), **kw)
            assert td.to_dict() == jd.to_dict()
    # without a profile the modeled backprop drives it
    assert tsch.modeled_backprop_s(10 ** 6, 4096, 1e14) == jsch.modeled_backprop_s(
        10 ** 6, 4096, 1e14)
    assert tsch.resolve_schedule(TRC(kind="fft", transport="allgather", schedule="auto"),
                                 total) == ("stacked", None)
    assert tsch.resolve_schedule(TRC(kind="dense", transport="psum", bucket_bytes=4096 * 4,
                                     schedule="auto"), total) == ("stacked", None)
    assert tsch.resolve_schedule(TRC(kind="fft", transport="psum", schedule="streamed"),
                                 total) == ("streamed", None)
    assert decisions  # at least one verdict was taken


@pytest.mark.parametrize("backprop,alpha", [(1e11, 1e-6), (1e15, 5e-4), (3e12, 2e-5)])
def test_resolve_schedule_prices_the_streamed_step_without_overlap(backprop, alpha):
    """This package's streamed step starts its groups after the backward
    pass: ``auto`` prices it as backprop + every group's exchange, which
    costs a launch per group more than stacked, so ``auto`` never streams.
    The step time equals backprop + the summed exchange within 1e-12
    relative (the timeline adds group by group)."""
    _, tprof = _profiles(alpha=alpha, backprop=backprop)
    total = 40 * 4096 + 7
    red = dict(kind="fft", transport="sequenced", bucket_bytes=4 * 4096 * 4, schedule="auto")
    assert tsch.OVERLAPS_BACKWARD is False
    for groups in (None, 2, 3):
        name, dec = tsch.resolve_schedule(TRC(stream_groups=groups, **red), total, 4096,
                                          workers=2, profile=tprof)
        assert name == "stacked" and dec.schedule == "stacked"
        assert dec.streamed_step_s >= dec.stacked_step_s and dec.overlap_efficiency == 0.0
        plan = tsch.build_plan(tb.build_layout(total, red["bucket_bytes"]), groups)
        kw = dict(workers=2, transport="sequenced", group_fractions=plan.group_fractions(),
                  backprop_s=dec.backprop_s, profile=tprof, wire_mode="runtime")
        flat_plan = tcm.streamed_exchange_time_s(4.0 * total, 3e6, **kw, overlap=False)
        assert flat_plan.hidden_s == 0.0 and flat_plan.overlap_efficiency == 0.0
        # the timeline adds group by group, exchange_s sums the groups first
        assert math.isclose(flat_plan.step_s, dec.backprop_s + flat_plan.exchange_s,
                            rel_tol=1e-12)
        assert flat_plan.step_s > tcm.streamed_exchange_time_s(4.0 * total, 3e6, **kw).step_s


def test_reducer_config_schedule_checks():
    for bad in (dict(schedule="sideways"), dict(schedule="streamed", transport="allgather"),
                dict(stream_groups=0), dict(validate="paranoid")):
        with pytest.raises(ValueError):
            TRC(kind="fft", **bad)
    with pytest.raises(TypeError):
        TRC(kind="fft", faults=[("nan_grad", 1, 0)])


N = 7 * 4096 + 100
BUCKET_BYTES = 4096 * 4  # 8 buckets, the last one ragged


def _flat(seed=0):
    return (np.random.default_rng(seed).standard_normal(N) * 0.05).astype(np.float32)


@pytest.mark.parametrize("transport", ["sequenced", "psum"])
@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_run_plan_bitwise_run_layout(transport, stacked, backend):
    comp = tc.FFTCompressor(tc.FFTCompressorConfig(backend=backend, selector="auto"))
    layout = tb.build_layout(N, BUCKET_BYTES)
    x = torch.from_numpy(_flat(1))
    t = tt.get_transport(transport)
    for groups in (None, 3):
        plan = tsch.build_plan(layout, groups)
        for local in (True, False):
            a = t.run(x, comp=comp, layout=layout, local=local, stacked=stacked)
            b = t.run(x, comp=comp, plan=plan, local=local, stacked=stacked)
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        t.run(x, comp=comp, layout=layout, plan=plan)
    with pytest.raises(ValueError):
        t.run(x, comp=comp)


@pytest.fixture
def xla_rfft(monkeypatch):
    """torch.fft.rfft -> XLA's rfft of the same rows (shared stage input)."""
    def rfft(x, dim=-1):
        assert dim == -1
        z = np.asarray(jnp.fft.rfft(jnp.asarray(x.detach().numpy()), axis=-1))
        return torch.from_numpy(z.astype(np.complex64))

    monkeypatch.setattr(torch.fft, "rfft", rfft)


@pytest.mark.parametrize("port,ref", [("reference", "reference"), ("cuda", "pallas")])
def test_streamed_roundtrip_and_payloads_match_reference(xla_rfft, port, ref):
    flat = _flat(2)
    jplan = jsch.build_plan(jb.build_layout(N, BUCKET_BYTES), 3)
    tplan = tsch.build_plan(tb.build_layout(N, BUCKET_BYTES), 3)
    jcomp = jc.FFTCompressor(jc.FFTCompressorConfig(backend=ref, selector="sampled"))
    tcomp = tc.FFTCompressor(tc.FFTCompressorConfig(backend=port, selector="sampled"))
    jpays = jex.streamed_compress_fn(jcomp, jplan)(jnp.asarray(flat))
    tpays = tex.streamed_compress_fn(tcomp, tplan)(torch.from_numpy(flat))
    assert len(jpays) == len(tpays) == 3
    for jp, tp in zip(jpays, tpays):
        np.testing.assert_array_equal(np.asarray(jp.idx), tp.idx.numpy())
        assert tp.sizes == tuple(jp.sizes)
    jrec = np.asarray(jt.SequencedTransport().run(jnp.asarray(flat), comp=jcomp, plan=jplan))
    trec = tt.SequencedTransport().run(torch.from_numpy(flat), comp=tcomp, plan=tplan,
                                       local=True).numpy()
    pad = (-N) % 4096
    rows = lambda v: np.pad(v, (0, pad)).reshape(-1, 4096)  # noqa: E731
    scale = np.abs(rows(flat)).max(axis=1)
    assert (np.abs(rows(trec) - rows(jrec)).max(axis=1) <= 2e-6 * scale).all()
    np.testing.assert_array_equal(trec, tex.streamed_roundtrip_fn(tcomp, tplan)(
        torch.from_numpy(flat)).numpy())


def test_executor_entry_points_and_cache_keys():
    """The entry points are the transport's own compress and roundtrip
    (bitwise); eager PyTorch compiles nothing, so the reference's cache and
    its keys have no counterpart."""
    layout = tb.build_layout(N, BUCKET_BYTES)
    comp = tc.FFTCompressor(tc.FFTCompressorConfig(selector="sort"))
    x = torch.from_numpy(_flat(3))
    payload = tex.compress_fn(comp, layout)(x)
    ref = comp.compress_stacked(tb.stack_buckets(x, layout), layout.sizes())
    assert torch.equal(payload.idx, ref.idx) and torch.equal(payload.re, ref.re)
    rec = tex.roundtrip_fn(comp, layout)(x)
    assert torch.equal(rec, tt.SequencedTransport().run(x, comp=comp, layout=layout,
                                                        local=True))
    looped = tex.looped_compress_fn(comp, layout)(x)
    direct = comp.compress_buckets(tb.split_buckets(x, layout))
    assert len(looped) == layout.n_buckets
    assert all(torch.equal(a.idx, b.idx) and torch.equal(a.re, b.re)
               for a, b in zip(looped, direct))
    plan = tsch.build_plan(layout, 3)
    groups = tex.streamed_compress_fn(comp, plan)(x)
    assert [g.sizes for g in groups] == [sub.sizes() for _, _, sub in plan.group_slices()]
    for g, (lo, hi, sub) in zip(groups, plan.group_slices()):
        assert torch.equal(g.idx, comp.compress_stacked(tb.stack_buckets(x[lo:hi], sub),
                                                        sub.sizes()).idx)
    assert torch.equal(tex.streamed_roundtrip_fn(comp, plan)(x), rec)
    assert torch.equal(x, torch.from_numpy(_flat(3)))  # no donation: the input is intact
    assert not any(hasattr(tex, name) for name in ("cache_size", "clear_cache", "_CACHE"))


_WORKER = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.comms.reducers import ReducerConfig, make_reducer
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
grads = np.load(out + ".in.npy")
res = {}
for transport in ("sequenced", "psum"):
    for schedule, groups in (("stacked", None), ("streamed", None), ("streamed", 3)):
        r = make_reducer(ReducerConfig(kind="fft", transport=transport, bucket_bytes=4096 * 4,
                                       error_feedback=True, backend="auto", selector="auto",
                                       schedule=schedule, stream_groups=groups))
        resid = torch.zeros(grads.shape[1])
        for _ in range(2):
            mean, resid = r({"w": torch.from_numpy(grads[rank].copy())}, resid)
        res[f"{transport}.{schedule}.{groups}.mean"] = mean["w"].numpy()
        res[f"{transport}.{schedule}.{groups}.res"] = resid.numpy()
np.savez(out + f".{rank}.npz", **res)
dist.destroy_process_group()
"""


def test_two_gloo_workers_streamed_mean_bitwise_stacked(tmp_path):
    path = str(tmp_path / "x")
    np.save(path + ".in.npy",
            (np.random.default_rng(4).standard_normal((2, N)) * 0.1).astype(np.float32))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), str(port), path],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for rank in range(2)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log
    runs = [np.load(path + f".{rank}.npz") for rank in range(2)]
    for transport in ("sequenced", "psum"):
        base = f"{transport}.stacked.None"
        for rank in range(2):
            for streamed in (f"{transport}.streamed.None", f"{transport}.streamed.3"):
                for what in ("mean", "res"):
                    np.testing.assert_array_equal(runs[rank][f"{streamed}.{what}"],
                                                  runs[rank][f"{base}.{what}"])
        np.testing.assert_array_equal(runs[0][f"{base}.mean"], runs[1][f"{base}.mean"])
