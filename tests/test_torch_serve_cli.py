"""The port's serve CLI (`python -m repro_torch.launch.serve`) and the LM
entry points it drives, on the CPU (``--device cpu``).

`main` serves the reduced configs: a CNN with and without the seeded
chaos plan (its outcome, plan and health lines equal to the reference
CLI's on the same arguments), and Qwen1.5-4B, whose reference `Server`
does not run on this jax; `random_prompt_lengths` draws the reference's
lengths from a seeded generator.  `Server.run_batch` and
`LMBackend.reset` are held to `serve` and to a fresh request.
"""
import re
import sys

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401

from repro.launch import serve as ref_serve
from repro_torch.configs import get_config
from repro_torch.launch import serve as ts


def _lines(text: str, prefix: str) -> list[str]:
    return [ln.strip() for ln in text.splitlines()
            if ln.strip().startswith(prefix)]


def _ref_main(argv, capsys) -> str:
    old = sys.argv
    sys.argv = ["serve", *argv]
    try:
        ref_serve.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--cnn", "vscnn-resnet18", "--requests", "6", "--batch", "4"],
    ["--cnn", "vscnn-resnet18", "--requests", "12", "--batch", "4",
     "--replicas", "2", "--chaos-seed", "0"],
    ["--cnn", "vscnn-resnet18", "--requests", "12", "--batch", "4",
     "--replicas", "3", "--chaos-seed", "5"],
])
def test_cnn_main_matches_reference(argv, capsys):
    ts.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    want = _ref_main(argv, capsys)
    pat = r"served (\d+) images in (\d+) lockstep runs, [\d.]+ img/s \((.*)\)"
    g, w = re.search(pat, got), re.search(pat, want)
    assert g is not None and w is not None, got
    assert g.groups() == w.groups()
    for prefix in ("outcomes:", "plan:", "health:"):
        assert _lines(got, prefix) == _lines(want, prefix)
    if "--chaos-seed" in argv:
        assert _lines(got, "plan:") and _lines(got, "health:")
    stats = _lines(got, "{")
    assert len(stats) == int(g.group(2))


def test_lm_main_serves_every_token(capsys):
    ts.main(["--arch", "qwen1.5-4b", "--requests", "4", "--tokens", "8",
             "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"served 4 requests in (\d+) lockstep runs: (\d+) tokens",
                  out)
    assert m is not None, out
    assert int(m.group(2)) == 4 * 8
    assert len(_lines(out, "{")) == int(m.group(1))


@pytest.mark.parametrize("argv,message", [
    ([], "choose exactly one"),
    (["--arch", "qwen1.5-4b", "--cnn", "vscnn-resnet18"],
     "choose exactly one"),
    (["--cnn", "qwen1.5-4b"], "is an LM arch"),
    (["--arch", "vscnn-resnet18"], "is a CNN arch"),
])
def test_main_refuses_bad_arguments(argv, message, capsys):
    with pytest.raises(SystemExit):
        ts.main(argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("n,max_len,lo", [(16, 48, 8), (16, 8, 8),
                                          (5, 2, 8), (7, 100, 30)])
def test_random_prompt_lengths_match_reference(n, max_len, lo):
    got = ts.random_prompt_lengths(np.random.default_rng(0), n, max_len, lo)
    want = ref_serve.random_prompt_lengths(np.random.default_rng(0), n,
                                           max_len, lo)
    assert got == want
    assert all(1 <= v < max_len for v in got)
    if max_len == 8:
        assert set(got) == {7}


def test_random_prompt_lengths_refuse_short_max():
    with pytest.raises(ValueError, match=">= 2"):
        ts.random_prompt_lengths(np.random.default_rng(0), 3, 1)


@pytest.fixture(scope="module")
def lm_cfg():
    return get_config("qwen1.5-4b").reduce()


def _prompts(cfg, lens, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [ts.Request(rid=i, prompt=rng.integers(0, cfg.vocab, n,
                                                  dtype=np.int32),
                       max_new=max_new) for i, n in enumerate(lens)]


def test_run_batch_equals_serve(lm_cfg):
    """One lockstep run of 3 requests at batch 2 (the third backfills):
    the same tokens and counts as `serve`; a request that can never
    backfill into the run raises."""
    srv = ts.Server(lm_cfg, batch=2, capacity=64, device="cpu")
    a = _prompts(lm_cfg, [12, 10, 9], 4)
    b = _prompts(lm_cfg, [12, 10, 9], 4)
    st = srv.run_batch(a)
    (st2,) = srv.serve(b)
    assert [r.out for r in a] == [r.out for r in b]
    for k in ("decode_steps", "new_tokens", "finished", "backfills"):
        assert st[k] == st2[k], k
    assert st["backfills"] == 1 and st["new_tokens"] == 12
    long = _prompts(lm_cfg, [8, 8, 40], 4)   # 40 > the run's context
    with pytest.raises(ValueError, match="could not backfill"):
        srv.run_batch(long)


def test_lm_reset_regenerates_the_stream(lm_cfg):
    srv = ts.Server(lm_cfg, batch=2, capacity=64, device="cpu")
    reqs = _prompts(lm_cfg, [12, 10], 5)
    srv.serve(reqs)
    first = [list(r.out) for r in reqs]
    for r in reqs:
        srv.backend.reset(r)
        assert r.out == []
    srv.serve(reqs)
    assert [r.out for r in reqs] == first
