#!/usr/bin/env python3
"""Convert the JAX package's orbax checkpoints to the PyTorch port's files.

    python orbax_to_torch.py OUT_DIR/checkpoint/restore_pipeline --out pipeline.pt
    python orbax_to_torch.py OUT_DIR/checkpoint/psp --out psp.pt
    python orbax_to_torch.py ckpts/diffuser --out diffuser.pt   # and restore,
    python orbax_to_torch.py ckpts/lpips --out lpips.pt         # arcface, inception
    python orbax_to_torch.py ... --tiny --size 32 --decoder_size 64

The tree's layout says what it is, and the file written is the one the
port's matching flag reads:

  {"psp", "diffuser", "generator"[, "g_ema"]}  the trainers' restore_pipeline
      (_init) export -> the pipeline state_dict, g_ema as the generator
      when present (`cli/infer.py --ckpt`, as the JAX infer CLI serves it)
  {"encoder", "decoder", "latent_avg"}  stage 2's psp export -> the
      PSPFacade state_dict (`--psp_ckpt`)
  {"diffuser"}  -> {"diffuser": state_dict} (`--diffuser_ckpt`)
  {"g", "g_ema", "d"} (any of them)  -> the same keys, state_dicts
  {"id"} / {"lpips"} / {"inception"}  -> the bare state_dict
      (`--arcface_ckpt` / `--lpips_ckpt` / `--inception_ckpt`)

The last four are the JAX `cli/convert_ckpt.py` outputs. The trainers'
full checkpoints also hold optimizer states, step counters, the RNG key
and the iteration: those are not carried over, so a JAX training run
cannot be resumed in the port. Their parameters are converted (a stage-2
`code_diffuser` dir gives the diffuser file, a stage-3 `restore` dir the
g / g_ema / d file); a tree with nothing convertible raises.

Module sizes follow the CLIs' flags (`--size`, `--decoder_size`,
`--channel_multiplier`, `--tiny`); every tree is checked against the port
module it fills (`state_dict_from_jax`). This script is the one place that
imports both frameworks: JAX and orbax through `vspbfr_tpu.utils`, and
`vspbfr_tpu_torch.convert`. No module of the port imports it.
"""

from __future__ import annotations

import argparse

import numpy as np

# what the trainers' full checkpoints hold beside parameters
TRAINING_STATE = ("opt", "g_opt", "d_opt", "step", "g_step", "d_step",
                  "rng", "iter", "ada")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help="orbax checkpoint directory")
    p.add_argument("--out", required=True, help="port file to write")
    p.add_argument("--size", type=int, default=512,
                   help="pipeline resolution (RestoreNet, D, psp out_size)")
    p.add_argument("--decoder_size", type=int, default=1024,
                   help="StyleGAN2 decoder resolution")
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--tiny", action="store_true",
                   help="test-size networks (the port CLIs' --tiny)")
    return p


def port_tree(tree: dict, args) -> dict:
    """The port file's tree for a loaded orbax tree (see the docstring)."""
    from vspbfr_tpu_torch.cli.common import tiny_pipeline_kwargs
    from vspbfr_tpu_torch.convert import state_dict_from_jax
    from vspbfr_tpu_torch.losses import (
        LPIPS,
        InceptionV3Features,
        ResNet101Embedder,
    )
    from vspbfr_tpu_torch.models import (
        CodeDiffuser,
        Discriminator,
        PSPFacade,
        RestorationNet,
    )
    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    tree = tree.get("params", tree)
    dropped = sorted(k for k in TRAINING_STATE if k in tree)
    if dropped:
        print(f"not carried over (a JAX training run cannot be resumed in "
              f"the port): {dropped}")
    tiny = tiny_pipeline_kwargs(args.tiny)
    div = tiny.get("channel_div", 1)
    cm = args.channel_multiplier

    def restore_net():
        return RestorationNet(size=args.size, channel_multiplier=cm,
                              channel_div=div)

    if {"psp", "diffuser", "generator"} <= set(tree):
        pipe = RestorationPipeline(size=args.size,
                                   decoder_size=args.decoder_size,
                                   channel_multiplier=cm, **tiny)
        flax = {"psp": tree["psp"], "diffuser": tree["diffuser"],
                "generator": tree.get("g_ema", tree["generator"])}
        return state_dict_from_jax(flax, pipe)
    if {"encoder", "decoder", "latent_avg"} <= set(tree):
        return state_dict_from_jax(tree, PSPFacade(
            out_size=args.size, size=args.decoder_size, **tiny))
    for name, module in (("id", ResNet101Embedder), ("lpips", LPIPS),
                         ("inception", InceptionV3Features)):
        if name in tree:
            return state_dict_from_jax(tree[name], module())
    out = {}
    if "diffuser" in tree:
        out["diffuser"] = state_dict_from_jax(tree["diffuser"],
                                              CodeDiffuser())
    for name in ("g", "g_ema"):
        if name in tree:
            out[name] = state_dict_from_jax(tree[name], restore_net())
    if "d" in tree:
        out["d"] = state_dict_from_jax(tree["d"], Discriminator(
            size=args.size, channel_multiplier=cm, channel_div=div))
    if not out:
        raise ValueError(f"nothing to convert: the tree holds "
                         f"{sorted(tree)}, none a parameter tree this tool "
                         f"knows")
    return out


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vspbfr_tpu.utils import load_checkpoint
    from vspbfr_tpu_torch.utils import save_checkpoint

    tree = jax.tree.map(np.asarray, load_checkpoint(args.src))
    save_checkpoint(args.out, port_tree(tree, args))
    print(f"converted {args.src} -> {args.out}")


if __name__ == "__main__":
    main()
