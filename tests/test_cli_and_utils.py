"""CLI driver, debug-dump, and checkpoint subsystem tests (CPU oracle path)."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from armadillocudalinearinterpolation.cli.driver import main, build_parser
from armadillocudalinearinterpolation.utils.checkpoint import (
    ContinuationCheckpoint, ContinuationStep)
from armadillocudalinearinterpolation.utils.debug import (
    dump_map_stages, STAGES)


ARGS = ["--neurons", "512", "--realisations", "2", "--dtype", "float64",
        "--tol", "1e-8", "--fd-eps", "1e-7", "--quiet"]


def test_cli_single_solve(capsys):
    rc = main(ARGS + ["--steps", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "converged=True" in out
    assert "smoke test" in out


def test_cli_continuation_with_stability_and_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "sweep")
    rc = main(ARGS + ["--steps", "2", "--beta-step", "0.1",
                      "--stability", "--checkpoint", ck])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("converged=True") == 2
    assert "eigenvalues" in out
    # resume continues from step 2
    rc = main(ARGS + ["--steps", "1", "--checkpoint", ck, "--resume"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "resuming at step 2" in out
    steps = ContinuationCheckpoint(ck).load_all()
    assert [s.index for s in steps] == [0, 1, 2]
    assert steps[1].beta == pytest.approx(13.1589)
    assert steps[0].n_unstable is not None


@pytest.mark.slow
def test_cli_staged_sweep(capsys):
    # two --staged continuation steps share one jit cache; both must land
    # at the deep tolerance on their own step's map (params/key are traced
    # arguments of the cached programs)
    rc = main(["--neurons", "512", "--realisations", "8",
               "--dtype", "float64", "--staged", "--tol", "1e-7",
               "--max-events", "2048", "--steps", "2",
               "--beta-step", "0.2", "--quiet"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("converged=True") == 2


@pytest.mark.slow
def test_cli_staged_aot_warmup_sweep(capsys):
    # --aot-warmup must pre-populate the SAME program objects the sweep
    # uses (identity-checked inside staged_aot_warmup) and print the
    # trace/compile breakdown; the warmed step must still converge
    rc = main(["--neurons", "512", "--realisations", "4",
               "--dtype", "float64", "--staged", "--aot-warmup",
               "--tol", "1e-7", "--max-events", "2048", "--steps", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[aot]" in out and "programs" in out
    assert "converged=True" in out


def test_cli_shard_sweep(capsys):
    # --shard N: the sweep's solves run over an N-device mesh (GSPMD row
    # constraint; the conftest already forces 8 virtual CPU devices, so
    # the CLI's --cpu env-var bootstrap is not needed in-process)
    rc = main(ARGS + ["--steps", "1", "--shard", "8", "--realisations",
                      "16", "--fd-mode", "central"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "converged=True" in out


@pytest.mark.slow
def test_cli_frozen_sweep_with_stability(capsys):
    """--fd-mode frozen routes the plain sweep through newton_solve_frozen
    (fused residual + frozen-schedule FD), and --stability consumes its
    exported REAL Jacobian even on a 0-iteration step (the generic-solver
    identity-placeholder fallback must not discard it — round-3 review)."""
    rc = main(ARGS + ["--steps", "2", "--beta-step", "0.1",
                      "--fd-mode", "frozen", "--max-events", "2048",
                      "--realisations", "4", "--stability"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("converged=True") == 2
    assert "eigenvalues" in out

    # frozen + an explicit xla backend is refused loudly (the frozen
    # solver runs the df64 replay unconditionally — same contract as the
    # staged path)
    rc = main(ARGS + ["--steps", "1", "--fd-mode", "frozen",
                      "--evolve-backend", "xla"])
    assert rc == 2
    assert "replay" in capsys.readouterr().err


def test_cli_staged_requires_f64(capsys):
    rc = main(["--staged", "--quiet"])
    assert rc == 2
    assert "float64" in capsys.readouterr().err


def test_cli_bad_guess_arity(capsys):
    rc = main(ARGS + ["--guess", "0.3", "0.7"])
    assert rc == 2
    assert "--guess needs 3 values" in capsys.readouterr().err


def test_cli_resume_without_checkpoint(capsys):
    rc = main(ARGS + ["--resume"])
    assert rc == 2


def test_debug_dump_stages(tmp_path, cfg, params, key, z_ref):
    host = dump_map_stages(cfg, params, key, z_ref, tmp_path)
    for stage in STAGES:
        assert (tmp_path / f"{stage}.npy").exists(), stage
    assert host["coupling"].shape == (cfg.n_neurons,)
    assert host["averaged"].shape == (cfg.n_spikes,)
    # residual in the dump equals a direct evaluation (same key)
    from armadillocudalinearinterpolation import event_driven_map
    f = np.asarray(event_driven_map(cfg, params, key, z_ref))
    np.testing.assert_allclose(host["residual"], f, atol=1e-12)


def test_checkpoint_roundtrip(tmp_path):
    ck = ContinuationCheckpoint(tmp_path / "c")
    ck.save(ContinuationStep(index=0, beta=13.0, solution=np.arange(3.0),
                             residual_norm=1e-9, converged=True,
                             n_unstable=1,
                             eigenvalues=np.array([1 + 1j, 2, 3])))
    last = ck.last()
    assert last.index == 0
    np.testing.assert_array_equal(last.solution, np.arange(3.0))
    np.testing.assert_array_equal(last.eigenvalues, np.array([1 + 1j, 2, 3]))
    assert ContinuationCheckpoint(tmp_path / "empty").last() is None


def test_checkpoint_tolerates_truncated_tail(tmp_path):
    """A crash mid-append leaves one truncated final line; load_all skips it
    (the step wasn't durably recorded) instead of bricking --resume."""
    import warnings
    from armadillocudalinearinterpolation.utils.checkpoint import (
        ContinuationCheckpoint, ContinuationStep)
    ck = ContinuationCheckpoint(tmp_path / "c")
    ck.save(ContinuationStep(index=0, beta=13.0, solution=np.zeros(3),
                             residual_norm=1e-9, converged=True))
    ck.save(ContinuationStep(index=1, beta=13.1, solution=np.ones(3),
                             residual_norm=1e-9, converged=True))
    # simulate a crash mid-append of step 2
    with open(tmp_path / "c" / "steps.jsonl", "a") as f:
        f.write('{"index": 2, "beta":')
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        steps = ck.load_all()
    assert [s.index for s in steps] == [0, 1]

    # CRASH-THEN-RESAVE (round-3 review finding): the next save must
    # newline-terminate the truncated tail, NOT merge into it — a merged
    # line silently dropped the redone step and poisoned every later
    # load_all once more records followed.
    ck.save(ContinuationStep(index=2, beta=13.2, solution=2 * np.ones(3),
                             residual_norm=1e-9, converged=True))
    ck.save(ContinuationStep(index=3, beta=13.3, solution=3 * np.ones(3),
                             residual_norm=1e-9, converged=True))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the fragment line warns
        steps = ck.load_all()
        assert [s.index for s in steps] == [0, 1, 2, 3]
        assert ck.last().index == 3
    np.testing.assert_array_equal(steps[2].solution, 2 * np.ones(3))


def test_checkpoint_tolerates_truncated_final_payload(tmp_path):
    """An unreadable FINAL npz (crash during a pre-atomic-write save, or a
    torn disk) drops that step for redo; unreadable mid-history payloads
    are genuine data loss and raise."""
    import warnings
    ck = ContinuationCheckpoint(tmp_path / "c")
    for i in range(3):
        ck.save(ContinuationStep(index=i, beta=13.0 + i, converged=True,
                                 solution=i * np.ones(3),
                                 residual_norm=1e-9))
    npz2 = tmp_path / "c" / "step_00002.npz"
    npz2.write_bytes(npz2.read_bytes()[:20])      # torn final payload
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        steps = ck.load_all()
        assert [s.index for s in steps] == [0, 1]
        last = ck.last()
        assert last.index == 1                    # falls back one step
    np.testing.assert_array_equal(last.solution, np.ones(3))
    # mid-history payload loss is a hard error
    (tmp_path / "c" / "step_00000.npz").unlink()
    with pytest.raises(ValueError, match="mid-history"):
        ck.load_all()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="mid-history"):
            # last() reads only the final payload (step 1 readable), so
            # force the mid-history check via the torn final + missing 0
            npz1 = tmp_path / "c" / "step_00001.npz"
            npz1.write_bytes(npz1.read_bytes()[:20])
            ck.last()


def test_cli_predictor_stays_on_branch(capsys):
    # fast tier on purpose: this guards the in-round basin-hop regression
    # of the DEFAULT-ON --predict path (review finding: the only predictor
    # test must not live behind the slow marker)
    """The secant predictor must extrapolate only from two consecutive
    converged solutions — the original guess->solution pairing sent step 1
    of exactly this sweep (N=512 R=4 f64) into the coexisting fast wave
    family (z_2 ~ 11).  Every converged solution must stay on the slow
    family (z_2 ~ 1.37), and --predict must still converge every step."""
    rc = main(["--neurons", "512", "--realisations", "4",
               "--dtype", "float64", "--tol", "1e-8", "--fd-eps", "1e-7",
               "--quiet", "--steps", "4", "--beta-step", "0.1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("converged=True") == 4
    import re
    for m in re.finditer(r"Z=\[([^\]]+)\]", out):
        z = [float(x) for x in m.group(1).split()]
        assert z[2] < 2.0, f"basin hop to the fast family: {z}"


def test_predicted_retry_needed_covers_soft_failures():
    """ADVICE r4: a predicted sweep step retries the plain reference warm
    start on ANY failure — finite non-convergence included, not just NaN
    (a finitely-failed extrapolated iterate would otherwise seed the next
    step and diverge from Driver.cu:107-109 behavior)."""
    from types import SimpleNamespace

    from armadillocudalinearinterpolation.cli.driver import (
        predicted_retry_needed)

    ok = SimpleNamespace(converged=True, solution=np.array([1.0, 2.0]))
    soft = SimpleNamespace(converged=False, solution=np.array([1.0, 2.0]))
    hard = SimpleNamespace(converged=False,
                           solution=np.array([np.nan, 2.0]))
    # converged=True with a NaN iterate cannot normally happen, but the
    # retry must still fire if it does (the hard-stop below would end the
    # sweep otherwise)
    weird = SimpleNamespace(converged=True, solution=np.array([np.inf]))
    assert not predicted_retry_needed(ok)
    assert predicted_retry_needed(soft)
    assert predicted_retry_needed(hard)
    assert predicted_retry_needed(weird)


def test_cache_honours_jax_compilation_cache_dir(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    no other is set in code."""
    from armadillocudalinearinterpolation.utils import cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert cache.enable_compilation_cache() == str(tmp_path / "cc")
    assert (tmp_path / "cc").is_dir()
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_repo_dir(monkeypatch):
    from armadillocudalinearinterpolation.utils import cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cache.enable_compilation_cache()
    assert got == str(cache._DEFAULT_DIR)
    assert cache._DEFAULT_DIR.name == ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == got


@pytest.mark.parametrize("argv", [
    ["--evolve-backend", "replay"],
    ["--fd-mode", "frozen"],
    ["--fd-mode", "frozen-fwd", "--arclength"],
    ["--staged", "--dtype", "float64", "--stage2-fd", "frozen"],
])
def test_cli_refuses_replay_on_gpu(monkeypatch, capsys, argv):
    """Options that run the df64 replay stop with rc 2 and a reason on a
    GPU backend, before any map evaluation."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    rc = main(argv + ["--quiet"])
    captured = capsys.readouterr()
    assert rc == 2
    assert "GPU" in captured.err
    assert "smoke test" not in captured.out


def test_cli_default_fd_eps_follows_grid(capsys):
    """Without --fd-eps the FD step is dx/8, below the grid spacing at any
    N, so the staircase warning (which the old default 1e-2 set off at
    N=1024) stays quiet, and --staged reports nothing ignored."""
    assert build_parser().parse_args([]).fd_eps is None
    rc = main(["--neurons", "1024", "--realisations", "2", "--tol", "1e-3",
               "--max-iter", "3", "--quiet"])
    err = capsys.readouterr().err
    assert rc in (0, 1)
    assert "grid spacing" not in err
    rc = main(["--neurons", "1024", "--realisations", "2", "--tol", "1e-3",
               "--max-iter", "3", "--quiet", "--fd-eps", "1e-2"])
    assert "grid spacing" in capsys.readouterr().err
