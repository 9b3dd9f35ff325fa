"""The port's entry points and example twins against the JAX package's.

In process: the demo query stream (``query_batches``) and the whole-stream
prepass (``prepass_routing``, ``fixed_q_max``) of
``repro_torch.launch.serve_sharded`` are bitwise the JAX package's, for
uniform and zipf-skewed streams on an artifact's grid and on a dataset.

In subprocesses, each with its own timeout, on ``--device cpu`` at tiny
sizes: ``python -m repro_torch.api.smoke``; ``python -m
repro_torch.launch.serve --gp`` with and without ``--sharded`` (the
sharded warm-up's tolerance ratio against the replicated answers, <= 1,
as ``ref.tolerance_ratio`` of the blend's summed terms); ``--gp --http``
answering a request; ``python -m repro_torch.launch.serve_sharded`` on the
one-process program and under ``torchrun`` on the mesh lane (each
assertion carrying the command's return code and both streams' tails),
and the lane's teardown (``serve_sharded.close_mesh_group``) in process;
the refusals
(``--sharded`` or ``--http`` without ``--gp``, no GPU without ``--device
cpu``); ``--help`` of every new CLI touching no CUDA state and no
process group; each ``examples/*_torch.py`` twin (``serve_demo_torch.py``
in its LM mode, the default, on recurrentgemma-2b and on whisper-base,
and under ``--gp``); ``launch.serve --arch`` and ``launch.train --arch``
at ``--smoke`` for the MoE, MLA, xLSTM, VLM, RG-LRU and encoder-decoder
architectures.
"""
from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.core.partition import PartitionGrid as JGrid
from repro.core.partition import make_grid as jmake_grid
from repro.data.spatial import e3sm_like_field as j_field
from repro.launch import serve_sharded as jss
from repro_torch.core.partition import PartitionGrid as TGrid
from repro_torch.core.partition import make_grid as tmake_grid
from repro_torch.data.spatial import e3sm_like_field as t_field
from repro_torch.launch import serve_sharded as tss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port", "psvgp_e3sm")

TINY_GP = ["--gp-n", "300", "--gp-grid", "2", "--gp-m", "4", "--gp-train-iters", "20",
           "--gp-batch", "64", "--gp-requests", "3", "--device", "cpu"]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH="src", CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", **extra)
    return env


def _run(argv: list[str], timeout: float, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *argv], cwd=REPO, env=_env(**env),
                          capture_output=True, text=True, timeout=timeout)


def _grids(source: str):
    """(JAX grid, port grid, JAX ds or None, port ds or None)."""
    if source == "artifact":  # the committed 400-cell artifact's grid, as both loads build it
        with open(os.path.join(FIXTURE, "artifact.json")) as f:
            g = json.load(f)["grid"]
        fields = (g["gx"], g["gy"], np.asarray(g["x_edges"], np.float64),
                  np.asarray(g["y_edges"], np.float64), g["wrap_x"])
        return JGrid(*fields), TGrid(*fields), None, None
    jds, tds = j_field(n=2000, seed=5), t_field(n=2000, seed=5)
    return jmake_grid(jds.x, 5, 4), tmake_grid(tds.x, 5, 4), jds, tds


@pytest.mark.parametrize("skew", [0.0, 1.1])
@pytest.mark.parametrize("source", ["artifact", "dataset"])
def test_query_batches_are_the_jax_stream_bitwise(source, skew):
    jg, tg, jds, tds = _grids(source)
    np.testing.assert_array_equal(tg.x_edges, jg.x_edges)
    np.testing.assert_array_equal(tg.y_edges, jg.y_edges)
    want = jss.query_batches(jg, jds, batch=300, requests=4, seed=3, skew=skew)
    got = tss.query_batches(tg, tds, batch=300, requests=4, seed=3, skew=skew)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("headroom,pad", [(1.25, 8), (1.0, 16)])
@pytest.mark.parametrize("skew", [0.0, 1.1])
@pytest.mark.parametrize("source", ["artifact", "dataset"])
def test_prepass_routing_is_the_jax_prepass_bitwise(source, skew, headroom, pad):
    jg, tg, jds, tds = _grids(source)
    batches = jss.query_batches(jg, jds, batch=500, requests=3, seed=7, skew=skew)
    jq, jcells = jss.prepass_routing(jg, batches, headroom=headroom, pad_multiple=pad)
    tq, tcells = tss.prepass_routing(tg, batches, headroom=headroom, pad_multiple=pad)
    assert tq == jq and tq % pad == 0
    for (tx, ty), (jx, jy) in zip(tcells, jcells, strict=True):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    assert tss.fixed_q_max(tg, batches, headroom=headroom, pad_multiple=pad) == \
        jss.fixed_q_max(jg, batches, headroom=headroom, pad_multiple=pad)


# ---------------------------------------------------------------------------
# the CLIs, in subprocesses
# ---------------------------------------------------------------------------


def test_api_smoke_exits_zero_on_the_cpu_when_asked():
    r = _run(["-m", "repro_torch.api.smoke", "--device", "cpu", "--grid", "2", "--n", "300",
              "--train-iters", "20", "--requests", "2", "--batch", "64"], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "bitwise == in-memory" in r.stdout and "api-smoke OK" in r.stdout
    ratio = float(re.search(r"tolerance ratio vs replicated ([0-9.e+-]+)", r.stdout).group(1))
    assert ratio <= 1


def test_serve_gp_replicated_on_the_cpu():
    r = _run(["-m", "repro_torch.launch.serve", "--gp", *TINY_GP], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "served 3 requests x 64 points" in r.stdout and "p50=" in r.stdout
    assert "on cpu" in r.stdout


@pytest.mark.parametrize("argv", [
    ["-m", "repro_torch.launch.serve", "--gp", "--sharded"],
    ["-m", "repro_torch.launch.serve_sharded", "--gp-skew", "1.1", "--gp-router", "two-level"],
    ["-m", "repro_torch.launch.serve_sharded", "--gp-serial"],
], ids=["serve-sharded", "serve_sharded-two-level-skew", "serve_sharded-serial"])
def test_sharded_cli_warmup_agrees_with_replicated(argv):
    r = _run([*argv, *TINY_GP], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "lane: one-process halo program" in r.stdout
    m = re.search(r"tolerance ratio mean ([0-9.e+-]+) var ([0-9.e+-]+)", r.stdout)
    assert m is not None, r.stdout
    assert float(m.group(1)) <= 1 and float(m.group(2)) <= 1  # ref.tolerance_ratio
    assert "served 3 requests x 64 points" in r.stdout


def _diagnostics(rc, stdout, stderr) -> str:
    """A command's return code and the tails of both its streams."""
    out, err = ((s.decode(errors="replace") if isinstance(s, bytes) else s or "")
                for s in (stdout, stderr))
    return (f"rc={rc}\n--- stdout (tail) ---\n{out[-3000:]}"
            f"\n--- stderr (tail) ---\n{err[-3000:]}")


def test_serve_sharded_under_torchrun_serves_on_the_mesh_lane():
    # --standalone: the rendezvous store binds a port the OS picks
    try:
        r = _run(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                  "-m", "repro_torch.launch.serve_sharded", *TINY_GP], timeout=240)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"no exit within 240 s\n{_diagnostics(None, e.stdout, e.stderr)}")
    why = _diagnostics(r.returncode, r.stdout, r.stderr)
    assert r.returncode == 0, why
    assert "lane: mesh over 4 ranks (gloo)" in r.stdout, why
    assert "0.192 kB/rank (1/4 of replicated)" in r.stdout, why
    m = re.search(r"tolerance ratio mean ([0-9.e+-]+) var ([0-9.e+-]+)", r.stdout)
    assert m is not None, why
    assert float(m.group(1)) <= 1 and float(m.group(2)) <= 1, why
    # 4 shifts a request: the warm-up and 3 requests
    assert "rank 0 exchange: 16 shifts" in r.stdout, why
    assert r.stdout.count("served 3 requests") == 1, why  # rank 0 alone reports


def test_close_mesh_group_frees_the_group_the_servers_cycles_hold(tmp_path):
    """The mesh lane's teardown: the server's stages and the mesh's shift
    hold the gloo group in reference cycles, so ``destroy_process_group``
    alone leaves it alive until a collection (at exit: the interpreter's
    finalization, where destroying it could abort a ``torchrun`` rank);
    ``close_mesh_group`` frees it before it returns."""
    import gc
    import weakref

    import torch
    import torch.distributed as dist

    from repro_torch import api

    torch.set_num_threads(1)
    fitted = api.fit(api.FitConfig(grid=1, m=4, train_iters=5, seed=0), t_field(n=200, seed=0),
                     device="cpu")
    gc.disable()  # no incidental collection between the two reads
    try:
        for close in (False, True):
            dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / f"s{close}"), 1),
                                    rank=0, world_size=1)
            group = dist.group.WORLD
            alive = weakref.ref(group)
            server = api.Server(fitted, api.ServeConfig(mode="sharded"), group=group)
            assert server.mesh is not None and server.submit(np.zeros((8, 2), np.float32))
            del server
            if close:
                tss.close_mesh_group(group)
            else:
                dist.destroy_process_group()
            del group
            assert not dist.is_initialized()
            assert (alive() is None) == close  # the cycles kept it without the collection
            gc.collect()
            assert alive() is None
    finally:
        gc.enable()
        if dist.is_initialized():
            dist.destroy_process_group()


def test_serve_gp_http_answers_a_request(tmp_path):
    from repro_torch.net.client import NetClient

    session = tmp_path / "session.json"
    session.write_text(json.dumps({"net": {"port": 0}}))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve", "--gp", "--http", "--config",
         str(session), *TINY_GP], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stdout:
            if "http://127.0.0.1:" in line:
                port = int(line.split("http://127.0.0.1:")[1].split()[0])
                break
        assert port is not None, proc.stderr.read()[-3000:]
        with NetClient("127.0.0.1", port) as c:
            resp = c.predict(np.zeros((5, 2), np.float32))
            slo = c.slo()
        assert resp.mean().shape == (5,) and np.isfinite(resp.var()).all()
        assert slo["serve_config"]["mode"] == "replicated"
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)


@pytest.mark.parametrize("argv,needle", [
    (["--sharded"], "add --gp"),
    (["--http"], "add --gp"),
    ([], "--arch required (or --gp"),
    (["--gp", "--gp-requests", "0"], "must be >= 1"),
], ids=["sharded-without-gp", "http-without-gp", "nothing", "zero-requests"])
def test_serve_refuses(argv, needle):
    r = _run(["-m", "repro_torch.launch.serve", *argv], timeout=120)
    assert r.returncode != 0 and needle in r.stderr, r.stderr[-2000:]


def test_serve_lm_decodes_a_smoke_model_on_the_cpu():
    r = _run(["-m", "repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--smoke", "--device",
              "cpu", "--gen", "4", "--temperature", "0"], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "arch=qwen3-0.6b-smoke device=cpu" in r.stdout
    assert "prefill: 4x64 tokens in" in r.stdout
    assert "decode: 4 steps x 4 seqs in" in r.stdout
    row = re.search(r"sample row 0: \[([0-9 ]+)\]", r.stdout).group(1).split()
    assert len(row) == 4 and all(0 <= int(t) < 512 for t in row)


def test_train_lm_runs_and_resumes_on_the_cpu(tmp_path):
    argv = ["-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b", "--smoke", "--device",
            "cpu", "--batch", "2", "--seq", "32", "--log-every", "2", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    r = _run([*argv, "--steps", "4"], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    losses = [float(v) for v in re.findall(r"loss ([0-9.]+)", r.stdout)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert (tmp_path / "step_00000004").is_dir() and "done." in r.stdout
    r = _run([*argv, "--steps", "2"], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "restored checkpoint at step 4" in r.stdout and "step     6" in r.stdout
    assert (tmp_path / "latest").read_text() == "step_00000006"


def test_entry_points_refuse_to_run_without_a_gpu_unless_told_cpu():
    tiny = [a for a in TINY_GP if a not in ("--device", "cpu")]
    r = _run(["-m", "repro_torch.launch.serve", "--gp", "--sharded", *tiny], timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr and "served" not in r.stdout
    r = _run(["-m", "repro_torch.api.smoke", "--grid", "2", "--n", "300"], timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    r = _run(["-m", "repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--smoke"], timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr and "prefill" not in r.stdout
    r = _run(["-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b", "--smoke", "--steps",
              "1"], timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr and "parameters" not in r.stdout


@pytest.mark.parametrize("target", [
    "-m repro_torch.launch.serve", "-m repro_torch.launch.serve_sharded",
    "-m repro_torch.api.smoke", "-m repro_torch.net.server", "-m repro_torch.launch.train",
    "examples/quickstart_torch.py", "examples/delta_sweep_torch.py",
    "examples/e3sm_insitu_torch.py", "examples/serve_demo_torch.py",
    "examples/lm_train_torch.py",
])
def test_help_touches_no_cuda_state_and_no_process_group(target):
    # RANK/WORLD_SIZE set as under torchrun: --help must still not
    # initialize a process group
    kind, name = target.split() if target.startswith("-m") else ("path", target)
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.argv = [{name!r}, "--help"]
        try:
            if {kind!r} == "-m":
                runpy.run_module({name!r}, run_name="__main__", alter_sys=True)
            else:
                runpy.run_path({name!r}, run_name="__main__")
        except SystemExit as e:
            assert e.code in (0, None), e.code
        import torch, torch.distributed as dist
        print("CUDA", torch.cuda.is_initialized(), "PG", dist.is_initialized())
    """)
    r = _run(["-c", code], timeout=120, RANK="0", WORLD_SIZE="4")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "usage:" in r.stdout
    assert r.stdout.strip().splitlines()[-1] == "CUDA False PG False"


@pytest.mark.parametrize("argv,needle", [
    (["examples/quickstart_torch.py", "--n", "600", "--grid", "3", "--iters", "20"],
     "boundary RMSD"),
    (["examples/delta_sweep_torch.py", "--n", "600", "--grid", "3", "--iters", "20",
      "--deltas", "0", "0.5"], "(ISVGP)"),
    (["examples/delta_sweep_torch.py", "--n", "600", "--grid", "3", "--iters", "20",
      "--deltas", "0.125", "--comm", "ppermute"], "comm=ppermute"),
    (["examples/e3sm_insitu_torch.py", "--sim-steps", "3", "--n-obs", "600", "--grid", "3",
      "--first-fit-iters", "20", "--iters-per-step", "10"], "replays bitwise"),
    (["examples/serve_demo_torch.py", "--gp", "--n", "600", "--grid", "3", "--iters", "20",
      "--requests", "3", "--batch", "64"], "replicated/serial"),
    (["examples/serve_demo_torch.py", "--gp", "--sharded", "--n", "600", "--grid", "3",
      "--iters", "20", "--requests", "3", "--batch", "64"], "sharded/pipelined"),
    (["examples/serve_demo_torch.py", "--arch", "deepseek-moe-16b", "--prompt-len", "16",
      "--gen", "4"], "arch=deepseek-moe-16b-smoke device=cpu"),
    (["examples/serve_demo_torch.py", "--arch", "recurrentgemma-2b", "--prompt-len", "16",
      "--gen", "4"], "arch=recurrentgemma-2b-smoke device=cpu"),
    (["examples/serve_demo_torch.py", "--arch", "whisper-base", "--prompt-len", "16",
      "--gen", "4"], "frames: 4x20 x 64 through the encoder"),
    (["examples/lm_train_torch.py", "--steps", "20", "--batch", "2", "--seq", "32"],
     "step    20  loss"),
], ids=["quickstart", "delta_sweep", "delta_sweep-ppermute", "e3sm_insitu", "serve_demo",
        "serve_demo-sharded", "serve_demo-lm", "serve_demo-rglru", "serve_demo-whisper",
        "lm_train"])
def test_example_twin_runs_on_the_cpu(argv, needle):
    r = _run([*argv, "--device", "cpu"], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert needle in r.stdout
    nums = [float(v) for v in re.findall(r"(?:RMSPE|RMSD)\s*:?\s*\|?\s*([0-9.]+)", r.stdout)]
    assert all(np.isfinite(nums))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-30b-a3b", "minicpm3-4b"])
def test_lm_clis_serve_and_train_the_moe_and_mla_smoke_configs(arch):
    r = _run(["-m", "repro_torch.launch.serve", "--arch", arch, "--smoke", "--device", "cpu",
              "--prompt-len", "16", "--gen", "4", "--temperature", "0"], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"arch={arch}-smoke device=cpu" in r.stdout and "decode: 4 steps x 4 seqs" in r.stdout
    r = _run(["-m", "repro_torch.launch.train", "--arch", arch, "--smoke", "--device", "cpu",
              "--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1"], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    losses = [float(v) for v in re.findall(r"loss ([0-9.]+)", r.stdout)]
    assert len(losses) == 2 and np.isfinite(losses).all() and "done." in r.stdout


@pytest.mark.parametrize("arch", ["xlstm-350m", "internvl2-76b"])
def test_lm_clis_serve_and_train_the_xlstm_and_vlm_smoke_configs(arch):
    r = _run(["-m", "repro_torch.launch.serve", "--arch", arch, "--smoke", "--device", "cpu",
              "--prompt-len", "16", "--gen", "4", "--temperature", "0"], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"arch={arch}-smoke device=cpu" in r.stdout and "decode: 4 steps x 4 seqs" in r.stdout
    assert ("patches: 4x8 x 96 prepended" in r.stdout) == (arch == "internvl2-76b")
    r = _run(["-m", "repro_torch.launch.train", "--arch", arch, "--smoke", "--device", "cpu",
              "--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1"], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    losses = [float(v) for v in re.findall(r"loss ([0-9.]+)", r.stdout)]
    assert len(losses) == 2 and np.isfinite(losses).all() and "done." in r.stdout


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-base"])
def test_lm_clis_serve_and_train_the_rglru_and_encdec_smoke_configs(arch):
    r = _run(["-m", "repro_torch.launch.serve", "--arch", arch, "--smoke", "--device", "cpu",
              "--prompt-len", "16", "--gen", "4", "--temperature", "0"], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"arch={arch}-smoke device=cpu" in r.stdout and "decode: 4 steps x 4 seqs" in r.stdout
    assert ("frames: 4x20 x 64 through the encoder" in r.stdout) == (arch == "whisper-base")
    r = _run(["-m", "repro_torch.launch.train", "--arch", arch, "--smoke", "--device", "cpu",
              "--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1"], timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    losses = [float(v) for v in re.findall(r"loss ([0-9.]+)", r.stdout)]
    assert len(losses) == 2 and np.isfinite(losses).all() and "done." in r.stdout
