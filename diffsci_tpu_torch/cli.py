"""Command line of the port: ``python -m diffsci_tpu_torch <command>``.

The counterpart of ``diffsci_tpu/cli.py`` with its commands and flags,
plus ``--device`` (default: the CUDA card; ``--device cpu`` runs on the
CPU, and nothing falls back):

    python -m diffsci_tpu_torch info   --ckpt runs/mnist-edm/ckpt
    python -m diffsci_tpu_torch sample --ckpt runs/mnist-edm/ckpt \\
        --shape 28 28 1 --nsamples 64 --out samples.npy [--grid grid.png]
    python -m diffsci_tpu_torch serve  --ckpt runs/mnist-edm/ckpt \\
        --shape 28 28 1 --port 8000 [--batch-window-ms 5]
    python -m diffsci_tpu_torch profile trace.json [--plane cuda]

``sample`` and ``serve`` load the checkpoint through
``SamplerService.from_checkpoint`` (``description.json`` and
``state.pt``, as ``save_checkpoint`` writes them); ``serve`` takes the
flags of the JAX package's ``scripts/serve_http.py`` as well. ``profile``
summarises a torch.profiler Chrome trace (``profiling.py``).
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_ckpt_args(ap, with_shape=True):
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint dir (description.json + state.pt)")
    if with_shape:
        ap.add_argument("--shape", type=int, nargs="+", required=True,
                        help="sample shape without batch dim, e.g. 28 28 1")
    ap.add_argument("--ema-stds", type=float, nargs="*", default=[0.05],
                    help="EMA profiles the run trained with; empty = raw "
                         "weights")
    ap.add_argument("--nsteps", type=int, default=18)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")


def cmd_info(args):
    from diffsci_tpu_torch.checkpoint import load_description

    desc = load_description(args.ckpt)
    if not desc:
        print(f"no description.json under {args.ckpt}", file=sys.stderr)
        return 1
    print(json.dumps(desc, indent=1, default=str))
    return 0


def _service(args, **extra):
    from diffsci_tpu_torch.serving import SamplerService

    return SamplerService.from_checkpoint(
        args.ckpt, tuple(args.shape), ema_stds=args.ema_stds or None,
        device=args.device, nsteps=args.nsteps, **extra)


def cmd_sample(args):
    import numpy as np

    svc = _service(args, batch_buckets=(min(args.nsamples, 64),))
    out = svc.sample(args.nsamples, generator=args.seed)
    np.save(args.out, out)
    print(f"wrote {args.out} {out.shape}")
    if args.grid:
        from diffsci_tpu_torch.utils.images import save_image_grid
        save_image_grid(args.grid, out)
        print(f"wrote {args.grid}")
    svc.close()
    return 0


def cmd_serve(args):
    from diffsci_tpu_torch.serving import build_server

    svc = _service(args, batch_buckets=tuple(args.buckets),
                   batch_window_ms=args.batch_window_ms)
    print("warming up...", flush=True)
    times = svc.warmup()
    server = build_server(svc, args.port, host=args.host,
                          max_nsamples=args.max_nsamples)
    print(f"ready on {args.host}:{server.server_address[1]} (warmup "
          f"{times})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        svc.close()
    return 0


def cmd_profile(args):
    from diffsci_tpu_torch import profiling

    path = profiling.find_trace(args.logdir)
    trace = profiling.parse_trace(path)
    print(f"# {path}")
    if args.overview:
        for row in profiling.plane_overview(trace)[:20]:
            print(f"{row['busy_ms']:10.3f} ms {row['events']:7d} ev  "
                  f"{row['plane']} :: {row['line']}")
        print()
    rows = profiling.op_summary(trace, plane=args.plane, line=args.line)
    print(profiling.format_summary(rows, top=args.top))
    busy = profiling.device_busy_fraction(trace, plane=args.plane)
    print(f"\nbusy fraction ({args.plane}): {busy:.1%}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m diffsci_tpu_torch",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="print a checkpoint's description")
    p.add_argument("--ckpt", required=True)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("sample", help="sample from a checkpoint")
    _add_ckpt_args(p)
    p.add_argument("--nsamples", type=int, default=64)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--out", default="samples.npy")
    p.add_argument("--grid", default=None,
                   help="optional PNG image-grid path")
    p.set_defaults(fn=cmd_sample)

    p = sub.add_parser("serve", help="HTTP sampling server")
    _add_ckpt_args(p)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (loopback by default; the endpoint "
                        "has no auth: expose deliberately)")
    p.add_argument("--max-nsamples", type=int, default=256,
                   help="per-request sample cap (bounds JSON body size)")
    p.add_argument("--buckets", type=int, nargs="+", default=[8, 64])
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="aggregate concurrent requests arriving within "
                        "this window into one bucket run (0 = off)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("profile",
                       help="summarize a torch.profiler Chrome trace")
    p.add_argument("logdir", help="profiler logdir or trace .json path")
    p.add_argument("--plane", default="cuda",
                   help="'cuda' (device kernels, copies) or 'cpu' (host)")
    p.add_argument("--line", default=None,
                   help="substring filter on the event category (e.g. "
                        "'kernel')")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--overview", action="store_true",
                   help="also list every (plane, line) busy time")
    p.set_defaults(fn=cmd_profile)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
