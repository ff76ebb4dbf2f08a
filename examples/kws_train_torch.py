"""End-to-end run of the PyTorch port: train the Fig.-7 KWS model on
synthetic GSCD, then deploy it through the port's kernels and chip twin.

The paper's own experiment (§III-A): binary-activation ternary-weight 1-D
CNN, 12 classes, 1 s @ 16 kHz.  With --full this trains the exact 631Kb
reconstruction; the default reduced setting (4000 samples, width 24)
exercises the identical code path.  Training is checkpointed and
restartable.  The deploy exports the model (ternary weights, integer SA
thresholds), runs it through ``offline_logits`` (the kernel library: B.3,
B.6, B.7) and through the compiled program on the chip twin's executor,
and checks both against the QAT forward, bit for bit.

Run:  PYTHONPATH=src python examples/kws_train_torch.py [--full]
          [--steps N] [--device cuda|cpu]
(the default device is the card; ``--device cpu`` runs every kernel's
plain version on the CPU.)
"""
import argparse
import time

import torch

from repro_torch.core import compiler
from repro_torch.core.executor import Executor
from repro_torch.data import gscd
from repro_torch.kernels import ops
from repro_torch.models import kws
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train import optimizer as opt_lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="exact Fig.-7 reconstruction (16k samples, w=64)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = ops.resolve_device(None, args.device)

    spec = (kws.build_kws_spec() if args.full
            else kws.build_kws_spec(in_len=4000, width=24))
    print(f"model {spec.name}: {spec.model_size_kb:.0f}Kb, "
          f"{spec.total_macs/1e6:.0f}M MACs/inf, in_len={spec.in_len}, "
          f"device {dev}")

    params = kws.init_kws_params(spec, device=dev)
    ocfg = opt_lib.OptConfig(lr=args.lr, clip_norm=1.0)
    state = opt_lib.init_opt_state(ocfg, params)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        start, (state, params), _ = ckpt.restore(args.ckpt_dir,
                                                 (state, params))
        print(f"resumed from step {start}")

    def loss_fn(p, batch):
        return kws.kws_loss(p, *batch, spec)

    def on_dev(batch):
        return tuple(torch.as_tensor(a).to(dev) for a in batch)

    xe, ye = on_dev(gscd.batch(seed=7, step=10_000, batch_size=96,
                               n=spec.in_len))
    t0 = time.time()
    for i in range(start, args.steps):
        batch = on_dev(gscd.batch(seed=0, step=i, batch_size=args.batch,
                                  n=spec.in_len))
        loss, grads = loop.value_and_grad(loss_fn, params, batch)
        state, _ = opt_lib.update(ocfg, state, grads)
        params = opt_lib.cast_params_like(state["master"], params)
        if (i + 1) % args.eval_every == 0 or i == start:
            with torch.no_grad():
                acc = float(kws.kws_accuracy(params, xe, ye, spec))
            print(f"step {i+1:4d} loss {float(loss):.4f} "
                  f"eval-acc {acc:.3f} ({time.time()-t0:.0f}s)")
            if args.ckpt_dir:
                ckpt.save(args.ckpt_dir, i + 1, (state, params))

    # deploy: export -> the kernel library and the chip twin, each held to
    # the QAT forward bit for bit; CIM accuracy (the honest number)
    weights, thresholds = kws.export_kws(params, spec)
    hints = (kws.ROTATE_HINTS, kws.ROWSPLIT_HINTS) if args.full else ((), {})
    model = kws.prepare_offline(spec, weights, thresholds, device=dev)
    prog = compiler.compile_model(spec, weights, thresholds,
                                  rotate_hints=hints[0],
                                  rowsplit_hints=hints[1], device=dev)
    ex = Executor(prog)
    xe, ye = gscd.batch(seed=7, step=10_000, batch_size=48, n=spec.in_len)
    with torch.no_grad():
        qat = kws.kws_forward(params, torch.as_tensor(xe).to(dev), spec)
    qat = qat.to(torch.int64)
    correct = offline_equal = cim_equal = 0
    for x, y, want in zip(xe, ye, qat):
        off = kws.offline_logits(model, torch.as_tensor(x).to(dev))
        out = ex.run(x[:, None]).output.ravel()
        offline_equal += int(torch.equal(off.to(torch.int64), want))
        cim_equal += int(torch.equal(out.to(torch.int64), want))
        correct += int(int(out.argmax()) == int(y))
    led = ex.run(xe[0][:, None]).ledger.summary()
    n = len(ye)
    print(f"\nQAT == offline_logits on {offline_equal}/{n} clips, "
          f"QAT == chip twin on {cim_equal}/{n} ({dev})")
    print(f"CIM-executed accuracy: {correct}/{n} = {correct/n:.3f} "
          f"(synthetic GSCD; paper: 0.9253 on real)")
    print(f"simulated PSCNN chip (its ledger, not this device): "
          f"{led['latency_us']:.0f}us/inf, {led['gops']:.1f} GOPS, "
          f"{led['tops_per_w']:.0f} TOPS/W")
    if offline_equal != n or cim_equal != n:
        raise SystemExit("the deployed model differs from the QAT forward")


if __name__ == "__main__":
    main()
