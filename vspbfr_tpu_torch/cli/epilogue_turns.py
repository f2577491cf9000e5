"""Time K6 and K7 of this tree in turns against an earlier checkout's form
of the same kernels and wrappers, then serving end to end, on one card.

    python -m vspbfr_tpu_torch.cli.epilogue_turns --old DIR [--out FILE]
        [--no_serve]

DIR is an earlier checkout of the repository (for example
`git archive 3809002 | tar -x -C DIR`, with DIR under the git-ignored
`build/` inside the repository) whose `vspbfr_tpu_torch/ops/epilogue.py` and
`ops/fused_act.py` have K6 `conv_epilogue(x, out_scale, noise, bias, act,
...)` and K7 `fused_leaky_relu(x, bias)`. Those two modules and their
`ops/_build.py` are imported from DIR as they are (the earlier `_build`
builds DIR's kernels into DIR's `build/`), so the earlier form is timed
with its own host path: its casts, checks and autograd Function. The
earlier chain is one call where DIR's K6 takes `post_add`, else what its
`apply_epilogue` ran: K6, the post-adds in torch, K6 again for a second
stage.

At each `cli.profile` K6_CASES and K7_CASES row, b4, in f32 and bf16 (and
in bf16 with f32 operands at 64 px C512), it prints in the order old, new,
new, old: `device_ms` (the device's time, the host left out, rotating
through `cli.profile.l2_copies` copies of the operands) and `cuda_ms`
(one call's time on an idle stream, host included; a median of 50, as
the host's pace varies); both forms' max
difference from the plain version relative to its max |value|, their
launches per call, and the bound. Then, unless --no_serve, serving b4 at
full width in f32 and bf16, one process per tree in the order old, new,
new, old: the host-clock median of 7 `restore` calls ending in a sync, and
one traced call (`cli.profile.profile_restore`: idle share, K6 / K7
launches, device time by group).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from vspbfr_tpu_torch import ops
from vspbfr_tpu_torch.cli.profile import (K6_CASES, K7_CASES, _diffs,
                                          _rand_fn, bound_ms, card_name,
                                          cuda_ms, device_ms, in_turns,
                                          k6_operands, k6_work, l2_copies)

REPO = Path(__file__).resolve().parents[2]
# one call's time swings with the host's load: a median of many
CALL_ITERS = 50
ops_pkg = sys.modules["vspbfr_tpu_torch.ops"]


@contextlib.contextmanager
def _as_build(old_build):
    """Let modules imported in the block find `old_build` as
    `vspbfr_tpu_torch.ops._build`."""
    key = "vspbfr_tpu_torch.ops._build"
    saved = sys.modules[key], ops_pkg._build
    sys.modules[key] = ops_pkg._build = old_build
    try:
        yield
    finally:
        sys.modules[key], ops_pkg._build = saved


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_old(old: Path):
    """(K6 module, K7 module) of the earlier checkout, on its own build."""
    d = old / "vspbfr_tpu_torch" / "ops"
    old_build = _load(d / "_build.py", "old_vspbfr_build")
    with _as_build(old_build):
        k7 = _load(d / "fused_act.py", "old_vspbfr_fused_act")
        k6 = _load(d / "epilogue.py", "old_vspbfr_epilogue")
    k6.chain = "post_add" in inspect.signature(k6.conv_epilogue).parameters
    return k6, k7


def old_chain(k6, x, out_scale=None, noise=None, bias=None, act=True,
              post_add=(), noise2=None, bias2=None, act2=False):
    """The earlier `apply_epilogue`: one K6 call where the earlier K6 takes
    the chain, else K6, the post-adds in torch, K6 again for a second
    stage."""
    if k6.chain:
        return k6.conv_epilogue(x, out_scale, noise, bias, act, post_add,
                                noise2, bias2, act2)
    out = x
    if out_scale is not None or noise is not None or bias is not None or act:
        out = k6.conv_epilogue(x, out_scale, noise, bias, act)
    for p in post_add:
        out = out + p
    if noise2 is not None or bias2 is not None or act2:
        out = k6.conv_epilogue(out, None, noise2, bias2, act2)
    return out


def _counted(fn, counter):
    """fn's result and the launches `counter()` saw during the call."""
    before = counter()
    out = fn()
    return out, counter() - before


def _cases(dt):
    """(kernel, label, pieces or None, x shape, operand dtype)."""
    for xs, pieces, label in K6_CASES:
        yield "conv_epilogue", label, pieces, xs, dt
    if dt == torch.bfloat16:
        yield ("conv_epilogue", "styled 64px C512, f32 operands", "snba",
               (4, 64, 64, 512), torch.float32)
    for xs, label in K7_CASES:
        yield "fused_leaky_relu", label, None, xs, dt


def _f32(kw):
    return {k: (tuple(t.float() for t in v) if k == "post_add" else
                v.float() if torch.is_tensor(v) else v)
            for k, v in kw.items()}


def turns(k6_old, k7_old) -> list[dict]:
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        dt_name = "bf16" if dt == torch.bfloat16 else "f32"
        rand = _rand_fn(dt, torch.device("cuda"))
        for kernel, label, pieces, xs, op_dt in _cases(dt):
            if kernel == "conv_epilogue":
                def operands():
                    return k6_operands(rand, dt, xs, pieces, op_dt)

                def calls(x, kw):
                    return (lambda: old_chain(k6_old, x, **kw),
                            lambda: ops.conv_epilogue(x, **kw))

                x, kw = operands()
                ref = ops.epilogue_plain_chain(x.float(), **_f32(kw))
                flops, moved = k6_work(x, kw)
                old_count = lambda: k6_old.conv_epilogue.launches  # noqa: E731
            else:
                def operands():
                    return (rand(*xs),
                            {"bias": rand(xs[-1], scale=0.3).to(op_dt)})

                def calls(x, kw):
                    return (lambda: k7_old.fused_leaky_relu(x, **kw),
                            lambda: ops.fused_leaky_relu(x, **kw))

                x, kw = operands()
                ref = ops.fused_leaky_relu_plain(x.float(),
                                                 kw["bias"].float())
                flops = 3 * x.numel()
                moved = 2 * x.numel() * x.element_size() + \
                    kw["bias"].numel() * kw["bias"].element_size()
                old_count = lambda: k7_old.fused_leaky_relu.launches  # noqa
            new_count = lambda: ops.launch_counts()[kernel]  # noqa: E731
            old, new = calls(x, kw)
            with torch.no_grad():
                got, n_new = _counted(new, new_count)
                d_new = _diffs(got, ref)["max_rel_diff"]
                got, n_old = _counted(old, old_count)
                d_old = _diffs(got, ref)["max_rel_diff"]
                del got, ref
                # the device times rotate through operand copies past L2
                pairs = [calls(x, kw)] + [calls(*operands()) for _ in range(
                    l2_copies(moved) - 1)]
                dev_old, dev_new = in_turns(device_ms, [p[0] for p in pairs],
                                            [p[1] for p in pairs])
                del pairs
                call_old, call_new = in_turns(
                    lambda f: cuda_ms(f, iters=CALL_ITERS), old, new)
            b_ms, b_by = bound_ms(flops, moved, dt_name)
            r = dict(kernel=kernel, case=label, dtype=dt_name,
                     op_dtype="bf16" if op_dt == torch.bfloat16 else "f32",
                     old_device_ms=dev_old, new_device_ms=dev_new,
                     old_call_ms=call_old, new_call_ms=call_new,
                     old_rel=d_old, new_rel=d_new, old_launches=n_old,
                     new_launches=n_new, bound_ms=b_ms, bound_by=b_by,
                     copies=l2_copies(moved))
            r["device_new_over_old"] = sum(dev_new) / sum(dev_old)
            r["call_new_over_old"] = sum(call_new) / sum(call_old)
            r["device_over_bound"] = min(dev_new) / b_ms
            rows.append(r)
            print(f"{kernel[:6]} {label:34s} {dt_name:4s} ops "
                  f"{r['op_dtype']:4s} device old {dev_old[0]:.4f} new "
                  f"{dev_new[0]:.4f} new {dev_new[1]:.4f} old "
                  f"{dev_old[1]:.4f} (x{r['device_new_over_old']:.3f}, "
                  f"{r['device_over_bound']:.2f}x bound, {r['copies']} "
                  f"copies) | call old {call_old[0]:.4f} new "
                  f"{call_new[0]:.4f} new {call_new[1]:.4f} old "
                  f"{call_old[1]:.4f} (x{r['call_new_over_old']:.3f}) | "
                  f"bound {b_ms:.4f} ({b_by}) | launches {n_old} -> {n_new} "
                  f"| rel diff old {d_old:.2e} new {d_new:.2e}", flush=True)
            del x, kw, old, new
    return rows


# one process per tree: serving b4 at full width in f32 and bf16, with only
# the names both trees' `cli.profile` and `pipeline` have
SERVE = r"""
import json, statistics, time
import torch
from vspbfr_tpu_torch.cli import profile as P
from vspbfr_tpu_torch.pipeline import RestorationPipeline
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for name, dt in (("f32", None), ("bf16", torch.bfloat16)):
    pipe = RestorationPipeline(size=P.SIZE, decoder_size=P.DECODER_SIZE,
                               compute_dtype=dt)
    pipe = pipe.init_from_seed(P.SEED).cuda().eval().prepare_params()
    gen = torch.Generator(device="cuda").manual_seed(P.SEED + 1)
    low = torch.rand((P.BATCH, P.SIZE, P.SIZE, 3), generator=gen,
                     device="cuda") * 2 - 1
    res = P.profile_restore(pipe, low)
    times = []
    for _ in range(7):
        rng = torch.Generator(device="cuda").manual_seed(P.SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.restore(low, rng, return_sample=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out[name] = dict(restore_ms=times,
                     restore_ms_median=statistics.median(times),
                     **{k: res[k] for k in ("wall_ms", "busy_ms", "window_ms",
                                            "idle_share", "launches",
                                            "device_ms_by_group")})
    del pipe, low, res
    torch.cuda.empty_cache()
print("SERVE " + json.dumps(out), flush=True)
"""


def serve_turns(old: Path) -> list[dict]:
    runs = []
    for label, tree in (("old", old), ("new", REPO), ("new", REPO),
                        ("old", old)):
        env = dict(os.environ, PYTHONPATH=str(tree))
        proc = subprocess.run([sys.executable, "-c", SERVE], cwd=tree, env=env,
                              capture_output=True, text=True)
        line = next((s for s in proc.stdout.splitlines()
                     if s.startswith("SERVE ")), None)
        if proc.returncode != 0 or line is None:
            raise RuntimeError(f"serving run of {tree} failed:\n"
                               + proc.stdout[-2000:] + proc.stderr[-4000:])
        res = json.loads(line[len("SERVE "):])
        runs.append({"tree": label, **res})
        for dt, r in res.items():
            g = r["device_ms_by_group"]
            print(f"serve {label} {dt:4s}: restore median "
                  f"{r['restore_ms_median']:.3f} ms, traced wall "
                  f"{r['wall_ms']:.3f} ms, busy {r['busy_ms']:.3f} of "
                  f"{r['window_ms']:.3f} ms (idle {r['idle_share']:.4f}), K6 "
                  f"{r['launches']['conv_epilogue']} launches "
                  f"{g.get('K6 conv_epilogue', 0.0):.3f} ms, K7 "
                  f"{r['launches']['fused_leaky_relu']} launches "
                  f"{g.get('K7 fused_leaky_relu', 0.0):.3f} ms, elementwise "
                  f"{g.get('elementwise', 0.0):.3f} ms", flush=True)
    return runs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--old", required=True, type=Path,
                   help="an earlier checkout with the one-stage K6")
    p.add_argument("--no_serve", action="store_true",
                   help="skip the end-to-end serving turns")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("epilogue_turns: needs a CUDA device")
    old = args.old.resolve()
    card = card_name()
    print(card, flush=True)
    res = {"card": card, "turns": turns(*load_old(old))}
    if not args.no_serve:
        res["serve"] = serve_turns(old)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
