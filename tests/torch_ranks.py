"""Rank workers for the port's multi-process tests.

`cdsegnet_torch.parallel.dist.launch` spawns processes that import their
worker by module name, so the workers live here rather than in a test file:
this module imports only torch, numpy and the port. `run_cases` reads a list
of cases that the test wrote with pickle, runs each on this rank, and writes
what each gave to ``<out_dir>/rank<r>.pkl``; `train_cli_stopped` runs the
training CLI on a rank and stops it after its first epoch.
"""

from __future__ import annotations

import copy
import logging
import os
import pickle
import types

import numpy as np
import torch

from cdsegnet_torch.data import datasets, loader
from cdsegnet_torch.engine import hooks
from cdsegnet_torch.engine.config import Config
from cdsegnet_torch.engine.events import EventStorage
from cdsegnet_torch.engine.optimizer import build_optimizer
from cdsegnet_torch.engine.state import make_eval_step, make_train_step
from cdsegnet_torch.engine.test import SemSegTester
from cdsegnet_torch.models.builder import build_model, build_model_criteria
from cdsegnet_torch.models.structure import make_point_batch
from cdsegnet_torch.parallel import dist


def _model(case):
    model = build_model(copy.deepcopy(case["model_cfg"]), device="cpu")
    model.load_state_dict(case["state"])
    return model


def _noise_fn(case):
    noise = case.get("noise")
    if noise is None:
        return None, []
    calls = []

    def fn(index, bucket, c_in):
        calls.append(index)
        assert noise[index].shape == (bucket, c_in)
        return noise[index]

    return fn, calls


def train_steps(case):
    """``case["steps"]`` steps of `make_train_step` on this rank's buckets
    with its draws injected; after each: loss, gradients, parameters,
    running statistics and the generators' states."""
    model = _model(case)
    opt = build_optimizer(case["optimizer"], model, case.get("scheduler"),
                          case["total_steps"], case["param_dicts"], device="cpu")
    step = make_train_step(model, build_model_criteria(case["model_cfg"]), opt,
                           device="cpu", microbatch=case["microbatch"])
    out = []
    for rank_steps in case["steps"]:
        micros, inject = rank_steps[dist.rank()]
        points = [make_point_batch(**m, device="cpu") for m in micros]
        metrics = step(points if case["microbatch"] > 1 else points[0], **inject)
        out.append(dict(
            loss=metrics["loss"].item(), valid_points=int(metrics["valid_points"]),
            grads={n: p.grad.clone() for n, p in model.named_parameters()
                   if p.grad is not None},
            params={n: p.detach().clone() for n, p in model.named_parameters()},
            buffers={n: b.clone() for n, b in model.named_buffers()},
            generators={k: g.get_state() for k, g in step.generators.items()}))
    return out


def evaluate(case):
    """`SemSegEvaluator` on a stub trainer over ``cfg.data.val``."""
    cfg = Config(Config._wrap(case["cfg"]))
    model = _model(case)
    noise_fn, calls = _noise_fn(case)
    log = logging.getLogger(f"torch_ranks.evaluate.{dist.rank()}")
    log.addHandler(logging.NullHandler())
    log.propagate = False
    tr = types.SimpleNamespace(
        cfg=cfg, epoch=case["epoch"], seed=cfg.get("seed", 0), model=model,
        device=torch.device("cpu"), logger=log, comm_info={}, storage=EventStorage(),
        eval_step=make_eval_step(model, cfg.serialization_depth, 1, "cpu"),
        val_loader=loader.EvalLoader(datasets.build_dataset(dict(cfg.data.val)),
                                     num_points=cfg.val_num_points))
    hook = hooks.SemSegEvaluator(noise_fn=noise_fn)
    hook.trainer = tr
    hook.after_epoch()
    return dict(histograms=hook.histograms, comm_info=tr.comm_info, calls=calls)


def run_tester(case):
    """`SemSegTester.test` of ``cfg.data.test``: records, result, the
    fragments this rank forwarded and the noise indices it asked for."""
    cfg = Config(Config._wrap(case["cfg"]))
    tester = SemSegTester(cfg, model=_model(case), device="cpu", verbose=False)
    forwarded = []
    forward = tester.forward_fragment

    def counting(point, noise):
        forwarded.append(int(point.mask.sum()))
        return forward(point, noise)

    tester.forward_fragment = counting
    noise_fn, calls = _noise_fn(case)
    miou = tester.test(noise_fn=noise_fn)
    return dict(miou=miou, records=tester.records, result=tester.result,
                forwarded=forwarded, calls=calls)


KINDS = dict(train_steps=train_steps, evaluate=evaluate, run_tester=run_tester)


class Stopped(Exception):
    """Raised by `StopAfterEpoch1`: an interrupted training run."""


def train_cli_stopped(argv) -> None:
    """`tools/train.py`'s `main` on this rank with a hook, `StopAfterEpoch1`,
    that ends the run after its first epoch on every rank (after a barrier,
    so that no rank is killed while the other still saves)."""
    from cdsegnet_torch.tools import train

    class StopAfterEpoch1(hooks.HookBase):
        def after_epoch(self):
            if self.trainer.epoch == 0:
                dist.barrier()
                raise Stopped("stopped after epoch 1")

    torch.set_num_threads(2)
    hooks.HOOKS.register_module("StopAfterEpoch1", StopAfterEpoch1)
    train.main(argv)


def run_cases(case_path: str, out_dir: str) -> None:
    torch.set_num_threads(2)
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    results = {name: KINDS[case["kind"]](case) for name, case in cases.items()}
    with open(os.path.join(out_dir, f"rank{dist.rank()}.pkl"), "wb") as f:
        pickle.dump(results, f)


def launch_cases(cases, tmp_dir: str, world: int = 2, timeout: float = 300.0):
    """Run ``cases`` on ``world`` gloo ranks on the CPU (killed after
    ``timeout`` seconds); returns each rank's results, in rank order."""
    case_path = os.path.join(tmp_dir, "cases.pkl")
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    dist.launch(run_cases, world, args=(case_path, tmp_dir), device="cpu",
                timeout=timeout)
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def numpy_point(pt) -> dict:
    """A JAX or port `PointBatch` as the keyword arguments of
    `make_point_batch`, in numpy."""
    return dict(coord=np.array(pt.coord), feat=np.array(pt.feat),
                grid_coord=np.array(pt.grid_coord), batch=np.array(pt.batch),
                mask=np.array(pt.mask), segment=np.array(pt.segment), depth=pt.depth,
                num_scenes=pt.num_scenes)
