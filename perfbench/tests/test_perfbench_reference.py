"""The comparison that decides ``correct``, on the CPU at reduced widths
(``_tiny``): the program's plain CPU path agrees with the reference, the
control (the reference with its float32 state in bfloat16) does not, and a
run driven through the harness with the timed path broken underneath comes
out not correct, once for each fault a training cell can have: the state
left unchanged, half of the batch left out, and (4 workers over gloo) the
exchange between them left out."""

import json
import os
import socket

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from _tiny import TINY_LIMIT, cell

from perfbench import bench
from perfbench.tools import readings

SEED = 2 ** 31 + 4567
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models are too small to share among threads, and the
    suite runs beside other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(name):
    c, arch = cell(name)
    return bench.worker(c, SEED, 0.0, False, 0, 1, CPU, 0.0, arch=arch)


@pytest.mark.parametrize("name", ["phi3m-l3.cdp.b4s512", "seamless.cdp.b8s1024",
                                  "phi3m-l3.dense.b4s512"])
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0
    assert all(c["value"] < TINY_LIMIT / 2 for c in res["checks"].values()), res["checks"]


def test_control_is_not_correct():
    c, arch = cell("phi3m-l3.cdp.b4s512")
    (row,) = readings.readings(c, [SEED], CPU, arch=arch, with_program=False,
                               log=lambda line: None)
    assert row["what"] == "control"
    assert max(row[k] for k in ("loss", "grad", "change")) > TINY_LIMIT, row


@pytest.mark.parametrize("name", ["phi3m-l3.cdp.b4s512", "phi3m-l3.dense.b4s512"])
def test_state_left_unchanged_is_not_correct(name, monkeypatch):
    from repro_torch.train import step

    monkeypatch.setattr(step, "apply_updates", lambda *a, **k: None)
    res = _run(name)
    assert not res["correct"] and res["checks"]["change"]["value"] == 1.0, res["checks"]


@pytest.mark.parametrize("name", ["phi3m-l3.cdp.b4s512", "seamless.cdp.b8s1024"])
def test_half_the_batch_is_not_correct(name, monkeypatch):
    from repro_torch.train import step

    whole = step._loss_and_grads

    def half(model, params, batch):
        return whole(model, params, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(step, "_loss_and_grads", half)
    res = _run(name)
    assert not res["correct"], res["checks"]


def _gloo_worker(rank, world, port, out, fault):
    from repro_torch.comms import transport

    torch.set_num_threads(1)

    if fault:  # every worker reduces its own payload alone
        transport.all_gather_payload = lambda payload, group=None: [payload] * world
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    c, arch = cell("phi3m-l3.cdp.b4s512.x4")
    res = bench.worker(c, SEED, 0.0, False, rank, world, CPU, 0.0, arch=arch)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "exchange_left_out"])
def test_four_workers(fault, tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = os.path.join(tmp_path, "result.json")
    mp.start_processes(_gloo_worker, args=(4, port, out, fault), nprocs=4, start_method="spawn")
    res = json.load(open(out))
    assert res["correct"] is (not fault), res["checks"]
