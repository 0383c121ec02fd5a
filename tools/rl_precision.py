"""GAIL's updates on the card against the CPU, in float64 and in float32, on
`chip_smoke.py` phase rl's data and draws: per parameter tensor, the L2
norm of card - CPU over the CPU's step, the largest element's share of the
CPU's mean step per update, and that element's gradient on both devices at
the update where its difference first reaches half its largest. Shows why phase rl bounds the L2 share and
only logs the largest element: Adam moves an element whose gradient sits
near its eps (1e-8) by g / (|g| + eps) of a step, so float32 noise in a
tiny gradient moves the step.

    python3 tools/rl_precision.py          # on a machine with a GPU
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def run(x, dev, dtype):
    g = cs.gail_learner(x, dev, dtype)
    before = [p.detach().double().cpu().clone() for p in g.net.parameters()]
    grads, params = [], []
    step = g.opt.step

    def recording_step(*args, **kwargs):
        grads.append([p.grad.detach().double().cpu().clone() for p in g.net.parameters()])
        return step(*args, **kwargs)

    g.opt.step = recording_step
    for _ in range(cs.RL_GAIL_UPDATES):
        g.update(x.expert, x.agent)
        params.append([p.detach().double().cpu().clone() for p in g.net.parameters()])
    return before, params, grads


def main():
    if not torch.cuda.is_available():
        print("rl_precision: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    x = cs.rl_inputs()
    names = [n for n, _ in cs.gail_learner(x, "cpu").net.named_parameters()]
    print(torch.cuda.get_device_name(0), flush=True)
    for dtype in (torch.float64, torch.float32):
        card, cpu = run(x, "cuda", dtype), run(x, "cpu", dtype)
        before, after = cpu[0], cpu[1][-1]
        unit = max(float((a - b).abs().max()) for a, b in zip(after, before)) / len(cpu[1])
        for i, name in enumerate(names):
            diff = card[1][-1][i] - cpu[1][-1][i]
            move = cpu[1][-1][i] - before[i]
            j = int(diff.abs().argmax())
            strays = [float((c[i] - h[i]).flatten()[j].abs()) for c, h in zip(card[1], cpu[1])]
            k = next(u for u, v in enumerate(strays) if v >= 0.5 * max(strays))
            print(f"{str(dtype):14s} {name:16s} L2 {float(diff.norm() / move.norm()):.3e} of the "
                  f"CPU's step; largest element {float(diff.abs().max()) / unit:.3e} of the mean "
                  f"step; at update {k + 1} its gradient {float(card[2][k][i].flatten()[j]):.4e} "
                  f"(card) {float(cpu[2][k][i].flatten()[j]):.4e} (CPU), the layer's largest "
                  f"{float(cpu[2][k][i].abs().max()):.4e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
