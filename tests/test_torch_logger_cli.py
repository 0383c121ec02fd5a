"""The port's episode logger and command line against the TPU package's:
the `train` CSV of the same episodes equal line for line
(tests/test_logger.py carried over), `get_args` the same namespace for the
same argv, and the dispatch of `main` on every `--algo` (on the CPU,
through a stub of `make`)."""
import os

import pytest

from plasticinelab_tpu.algorithms import solve as jsolve
from plasticinelab_tpu.algorithms.logger import Logger as JaxLogger
from plasticinelab_tpu_torch.algorithms import solve
from plasticinelab_tpu_torch.algorithms.logger import CSV_COLUMNS, Logger


def _info(loss, iou):
    return {"loss": loss, "sdf_loss": loss / 2, "density_loss": loss / 4,
            "contact_loss": loss / 8, "incremental_iou": iou}


EPISODES = (((1.0, False, 2.0, 0.1), (0.5, True, 4.0, 0.3)),
            ((2.0, True, 1.0, 0.5),),
            ((-0.25, False, 3.5, 0.0), (0.125, False, 0.5, 0.2), (1.5, True, 2.25, 0.7)))


def _log(logger):
    for episode in EPISODES:
        logger.reset()
        for reward, done, loss, iou in episode:
            logger.step(None, None, reward, None, done, _info(loss, iou))
    with open(os.path.join(logger.path, "train")) as f:
        return f.read().strip().split("\n")


def test_csv_matches_reference(tmp_path):
    ours = _log(Logger(str(tmp_path / "port")))
    theirs = _log(JaxLogger(str(tmp_path / "ref")))
    assert ours == theirs and len(ours) == 1 + len(EPISODES)
    assert ours[0] == ",".join(CSV_COLUMNS)
    row = dict(zip(CSV_COLUMNS, ours[1].split(",")))
    assert float(row["step"]) == 2 and float(row["reward"]) == 1.5
    assert float(row["loss"]) == 6.0 and float(row["sdf"]) == 3.0
    assert float(row["total_iou"]) == 0.4 and float(row["last_iou"]) == 0.3


def test_step_needs_reset(tmp_path):
    lg = Logger(str(tmp_path))
    with pytest.raises(AssertionError, match="reset"):
        lg.step(None, None, 0.0, None, True, _info(1.0, 0.0))


@pytest.mark.parametrize("argv", [
    [], ["--algo", "nn", "--env_name", "Torus-v2", "--num_steps", "500", "--lr", "0.3"],
    ["--algo", "sac", "--vec_envs", "32", "--num_steps", "20000", "--obs_mode", "rgb",
     "--image_obs_res", "42", "--image_obs_spp", "1", "--seed", "3"],
    ["--algo", "action", "--optim", "Momentum", "--host_loop", "--soft_contact_loss",
     "--sdf_loss", "5", "--density_loss", "2", "--contact_loss", "0.5", "--softness", "500",
     "--path", "/tmp/x", "--policy", "DDPG"],
])
def test_get_args_matches_reference(argv):
    assert vars(solve.get_args(argv)) == vars(jsolve.get_args(argv))
    assert solve.RL_ALGOS == jsolve.RL_ALGOS and solve.DIFF_ALGOS == jsolve.DIFF_ALGOS


@pytest.mark.parametrize("algo,entry,kw", [
    ("action", "optimizer.solver.solve_action", {}),
    ("nn", "optimizer.solver_nn.solve_nn", {}),
    ("sac", "algorithms.sac.run_sac.train", {}),
    ("discor", "algorithms.sac.run_sac.train", {}),
    ("td3", "algorithms.td3.run_td3.train_td3", {}),
    ("ppo", "algorithms.ppo.run_ppo.train_ppo", {"algo": "ppo"}),
    ("acktr", "algorithms.ppo.run_ppo.train_ppo", {"algo": "acktr"})])
def test_main_dispatches_on_the_device_asked(algo, entry, kw, tmp_path, monkeypatch):
    """main(argv, device=...) builds the env with the reference's flags on
    that device, seeds it and hands it to the algorithm's entry (as
    plasticinelab_tpu/algorithms/solve.py:89-109 dispatches) with the
    reference's default budget."""
    made, seeded, called = [], [], []

    class Env:
        class unwrapped:
            @staticmethod
            def seed(s):
                seeded.append(s)

    def fake_make(*a, **kw):
        made.append((a, kw))
        return Env()

    monkeypatch.setattr("plasticinelab_tpu_torch.envs.make", fake_make)
    monkeypatch.setattr("plasticinelab_tpu_torch." + entry,
                        lambda env, path, logger, args, **k: called.append((args, k)) or "done")
    out = solve.main(["--algo", algo, "--path", str(tmp_path), "--seed", "4"], device="cpu")
    assert out == "done" and seeded == [4]
    (make_args, make_kw), = made
    assert make_args == ("Move-v1",) and make_kw["device"] == "cpu"
    assert make_kw["nn"] == (algo == "nn")
    (args, entry_kw), = called
    assert args.algo == algo and entry_kw == kw
    assert args.num_steps == (10000 if algo in solve.DIFF_ALGOS else 500000)
    assert os.path.exists(tmp_path / "train")  # the logger's CSV
