"""Quickstart on the PyTorch port: the paper's pipeline end to end.

1. build the binary KWS CNN (reduced width),
2. QAT-train it briefly on the synthetic speech-commands corpus,
3. export ternary weights + SA thresholds,
4. compile to the PSCNN instruction set,
5. execute on the chip twin (the port's cycle-accurate CIM simulator,
   its MAC chunks on the port's kernels) and compare with QAT.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
          [--steps N] [--device cuda|cpu]
(the default device is the card; ``--device cpu`` runs every kernel's
plain version on the CPU.)  Exits non-zero if the chip twin's logits
differ from the QAT forward's.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import compiler
from repro_torch.core.executor import Executor
from repro_torch.data import gscd
from repro_torch.kernels import ops
from repro_torch.models import kws
from repro_torch.train import loop
from repro_torch.train import optimizer as opt_lib

BATCH, IN_LEN, WIDTH = 16, 2000, 16


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = ops.resolve_device(None, args.device)

    spec = kws.build_kws_spec(in_len=IN_LEN, width=WIDTH)
    print(f"model: {spec.total_weights} ternary weights "
          f"({spec.model_size_kb:.0f}Kb), {spec.total_macs/1e6:.1f}M MACs, "
          f"device {dev}")

    params = kws.init_kws_params(spec, device=dev)
    ocfg = opt_lib.OptConfig(lr=2e-3)
    state = opt_lib.init_opt_state(ocfg, params)

    def loss_fn(p, batch):
        return kws.kws_loss(p, *batch, spec)

    for i in range(args.steps):
        xb, yb = gscd.batch(seed=0, step=i, batch_size=BATCH, n=IN_LEN)
        loss, grads = loop.value_and_grad(
            loss_fn, params, (torch.as_tensor(xb).to(dev),
                              torch.as_tensor(yb).to(dev)))
        state, _ = opt_lib.update(ocfg, state, grads)
        params = opt_lib.cast_params_like(state["master"], params)
        if i % 5 == 0:
            print(f"  step {i:3d}  loss {float(loss):.4f}")

    weights, thresholds = kws.export_kws(params, spec)
    prog = compiler.compile_model(spec, weights, thresholds, device=dev)
    print(f"\ncompiled program: {len(prog.words)} instructions")
    print(prog.disassemble()[:600], "...\n")

    x, _ = gscd.batch(seed=9, step=0, batch_size=1, n=IN_LEN)
    rep = Executor(prog).run(x[0][:, None])
    with torch.no_grad():
        qat = kws.kws_forward(params, torch.as_tensor(x).to(dev), spec)[0]
    cim = np.asarray(rep.output.cpu()).ravel()
    qat = qat.cpu().numpy()
    exact = np.array_equal(cim.astype(float), qat.astype(float))
    print("CIM logits:", cim)
    print("QAT logits:", qat.astype(int))
    print("bit-exact:", exact)
    s = rep.ledger.summary()
    print(f"simulated PSCNN chip (its ledger, not this device): latency "
          f"{s['latency_us']:.0f}us | {s['gops']:.1f} GOPS | "
          f"{s['tops_per_w']:.0f} TOPS/W | {s['energy_uj']*1000:.1f} nJ/inf")
    if not exact:
        raise SystemExit("the chip twin differs from the QAT forward")
    return exact


if __name__ == "__main__":
    main()
