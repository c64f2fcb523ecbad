"""Fig. 7: trained-model accuracy under DS against the skew ablations; the
port's counterpart of ``benchmarks/fig7_accuracy.py``.

The paper's testbed task: cellular-traffic prediction (4 consecutive records
-> the next record), one model trained across 3 ECs on the data each
algorithm schedules; accuracy = the share of predictions within 15 % of the
target. Each CU's traffic distribution differs (non-IID), so a skewed
trained set hurts held-out accuracy across all communities, the effect
Fig. 7 shows. The model is a small MLP regressor (the paper used an LSTM;
the scheduling effect, not the architecture, is under test).

    PYTHONPATH=src python -m repro_torch.paper.fig7_accuracy [--device cpu]

``COCKTAIL_EXAMPLE_SLOTS`` sets the number of slots (``SLOTS`` when unset).

Every slot the decision is copied to the host once, to split the slot's
``BATCH`` records over the CUs in proportion to what it trains; the model's
steps run on the device without a host read.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from ..core import DS, NO_LSA, NO_SDC, NO_SLT, init_state, resolve_device, split_config, step
from ..core.types import DeviceLike
from ..data import TrafficSource
from ..examples import example_args
from .common import emit, testbed_config

SLOTS = 40
HIDDEN = 64
BATCH = 256  # records drawn a slot, split over the CUs
STEPS_PER_SLOT = 4  # optimizer steps on each slot's records
LR = 0.02
EVAL_EVERY = 10  # slots between held-out accuracy readings
HELD_OUT = 400  # held-out records per CU
SPECS = (DS, NO_SDC, NO_SLT, NO_LSA)


class TrafficMLP(nn.Module):
    """4 -> HIDDEN -> HIDDEN -> 1 with tanh. The weights are laid out as the
    JAX package's ``x @ w`` products take them (``w1`` (4, HIDDEN), ...) and
    drawn at its scales (0.3, 0.08, 0.08; zero biases) from ``generator``."""

    def __init__(self, hidden: int = HIDDEN, generator: torch.Generator | None = None,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)

        def normal(scale, *shape):
            return nn.Parameter((torch.randn(shape, generator=generator) * scale).to(dev))

        self.w1 = normal(0.3, 4, hidden)
        self.b1 = nn.Parameter(torch.zeros(hidden, device=dev))
        self.w2 = normal(0.08, hidden, hidden)
        self.b2 = nn.Parameter(torch.zeros(hidden, device=dev))
        self.w3 = normal(0.08, hidden, 1)
        self.b3 = nn.Parameter(torch.zeros(1, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ self.w1 + self.b1)
        h = torch.tanh(h @ self.w2 + self.b2)
        return (h @ self.w3 + self.b3)[:, 0]


def mlp_params_from_numpy(params: dict, device: DeviceLike = None) -> TrafficMLP:
    """A ``TrafficMLP`` holding the JAX package's weights ``w1 ... b3``
    (numpy arrays), on ``device`` (CUDA unless named)."""
    model = TrafficMLP(hidden=np.shape(params["w1"])[1], generator=torch.Generator(),
                       device=device)
    model.load_state_dict({name: torch.tensor(np.asarray(params[name], np.float32))
                           for name, _ in model.named_parameters()})
    return model


def clipped_grads(model: TrafficMLP, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor
                  ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """The w-weighted MSE of ``model`` on (x, y) and its gradient by
    parameter, clipped to global norm 1; all left on the device."""
    params = list(model.parameters())
    loss = torch.sum(w * (model(x) - y) ** 2) / torch.clamp(torch.sum(w), min=1e-9)
    grads = torch.autograd.grad(loss, params)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
    return loss.detach(), tuple(scale * g for g in grads)


def train_batch(model: TrafficMLP, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                lr: float = LR) -> torch.Tensor:
    """One SGD step of ``lr`` along ``clipped_grads``; returns the loss,
    left on the device."""
    loss, grads = clipped_grads(model, x, y, w)
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p.sub_(lr * g)
    return loss


def accuracy(model: TrafficMLP, xs: np.ndarray, ys: np.ndarray) -> float:
    """Share of the held-out records predicted within 15 % of the target."""
    with torch.no_grad():
        pred = model(torch.as_tensor(xs, device=model.w1.device)).cpu().numpy()
    rel = np.abs(pred - ys) / np.maximum(np.abs(ys), 1e-3)
    return float((rel <= 0.15).mean())


def draw_counts(x: np.ndarray, y: np.ndarray, prev: np.ndarray | None) -> np.ndarray | None:
    """Records to draw from each CU this slot: ``BATCH`` split by each CU's
    share of the samples the decision trains (x (N, M), y (N, M, M), the
    decision's float32 arrays on the host). A slot that trains nothing
    keeps the previous composition ``prev``."""
    trained = x + y.sum(axis=1)  # (N, M)
    per_cu = trained.sum(axis=1)
    total = per_cu.sum()
    if total > 0:
        return np.maximum((per_cu / total * BATCH).astype(int), 0)
    return prev


def decision_on_host(dec) -> tuple[np.ndarray, np.ndarray]:
    """The decision's x and y as float32 numpy arrays, in one copy."""
    n, m = dec.x.shape
    flat = torch.cat([dec.x.reshape(-1), dec.y.reshape(-1)]).cpu().numpy()
    return flat[:n * m].reshape(n, m), flat[n * m:].reshape(n, m, m)


def train_slot(model: TrafficMLP, sources, n_draw: np.ndarray | None) -> None:
    """One slot's training: ``n_draw[i]`` records from CU i, drawn in CU
    order, weighted 1, ``STEPS_PER_SLOT`` steps of ``train_batch``."""
    if n_draw is None or n_draw.sum() == 0:
        return
    xs, ys = [], []
    for i, n in enumerate(n_draw):
        if n == 0:
            continue
        x, y = sources[i].sample(int(n))
        xs.append(x)
        ys.append(y)
    dev = model.w1.device
    xt = torch.as_tensor(np.concatenate(xs), device=dev)
    yt = torch.as_tensor(np.concatenate(ys), device=dev)
    wt = torch.ones(yt.shape, device=dev)
    for _ in range(STEPS_PER_SLOT):
        train_batch(model, xt, yt, wt)


def fig7_accuracy(device: DeviceLike = None, slots: int = SLOTS) -> dict[str, list[float]]:
    """Each spec's held-out accuracy every ``EVAL_EVERY`` slots, trained on
    what it schedules at the testbed scale; prints one line a spec and the
    ``fig7/ds_at_least_competitive`` check. Runs on CUDA unless ``device``
    names another device."""
    if slots < EVAL_EVERY:
        raise ValueError(f"fig7_accuracy reads the accuracy every {EVAL_EVERY} slots; "
                         f"got slots={slots}")
    dev = resolve_device(device)
    cfg = testbed_config()
    sources = [TrafficSource(i, seed=7) for i in range(cfg.n_cu)]
    held = [s.sample(HELD_OUT) for s in sources]  # per-CU held-out sets
    xs_all = np.concatenate([h[0] for h in held])
    ys_all = np.concatenate([h[1] for h in held])

    _, params = split_config(cfg, None, dev)
    results = {}
    for spec in SPECS:
        model = TrafficMLP(generator=torch.Generator().manual_seed(0), device=dev)
        st = init_state(cfg, params)
        t0 = time.perf_counter()
        accs, n_draw = [], None
        for t in range(slots):
            st, _, dec = step(cfg, spec, st, params=params)
            n_draw = draw_counts(*decision_on_host(dec), n_draw)
            train_slot(model, sources, n_draw)
            if (t + 1) % EVAL_EVERY == 0:
                accs.append(accuracy(model, xs_all, ys_all))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        us = (time.perf_counter() - t0) * 1e6 / slots
        results[spec.name] = accs
        emit(f"fig7/accuracy/{spec.name}", us, ";".join(f"{a:.3f}" for a in accs))
    final = {k: v[-1] for k, v in results.items()}
    emit("fig7/ds_at_least_competitive", 0,
         str(final["ds"] >= max(v for k, v in final.items() if k != "ds") - 0.05).lower())
    return results


def main(argv=None) -> dict[str, list[float]]:
    device, slots = example_args(__doc__, argv, default_slots=SLOTS)
    return fig7_accuracy(device, slots)


if __name__ == "__main__":
    main()
