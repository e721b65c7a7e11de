"""Serving entry point: HTTP frontend with dynamic request batching
(counterpart of `fastvocoder_tpu/bin/serve.py`, without `--mesh`).  `--bf16
1` serves in bf16 (`compute_dtype`: parameters float32, the kernels' bf16
forms, a float32 waveform)."""

from __future__ import annotations

import argparse


def run_serve(argv=None, block: bool = True):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint_path", required=True,
                   help="release checkpoint (.npz, docs/checkpoints/) or a "
                        "checkpoint_<step>.pth.tar of bin/train.py")
    p.add_argument("--model_name", default="basis-melgan")
    p.add_argument("--config", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    p.add_argument("--bucket_frames", type=int, default=64)
    p.add_argument("--max_batch", type=int, default=32)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--bf16", type=int, default=0, help="1: compute in bf16")
    p.add_argument("--device", default="cuda")
    p.add_argument(
        "--warmup_frames", type=int, default=0,
        help="run every serving shape for utterances up to N mel frames "
        "once before accepting traffic",
    )
    args = p.parse_args(argv)

    import torch

    from fastvocoder_tpu_torch.serving import ServingModel, make_server, run_server

    model = ServingModel(
        args.checkpoint_path,
        args.config,
        args.model_name,
        bucket_frames=args.bucket_frames,
        max_batch=args.max_batch,
        device=args.device,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
    )
    if args.warmup_frames:
        n = model.warmup(args.warmup_frames)
        print(f"warmed {n} serving shapes", flush=True)
    httpd, batcher = make_server(
        model,
        input_channels=model.input_channels,
        model_name=args.model_name,
        host=args.host,
        port=args.port,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        validate=model.validate,
    )
    port = httpd.server_address[1]  # resolves --port 0
    print(f"serving {args.model_name} on http://{args.host}:{port}", flush=True)
    thread = run_server(httpd, batcher)
    if not block:  # embedding/tests: caller owns shutdown
        return httpd, batcher
    try:
        thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        batcher.close()


if __name__ == "__main__":
    run_serve()
