"""Convert the reference's released torch checkpoints to port state_dicts.

Counterpart of `vspbfr_tpu/cli/convert_ckpt.py`, with the same kinds and
flags and the port CLIs' `--decoder_size` and `--tiny`; it writes
(`utils.save_checkpoint`) the file that the port flag named beside each
kind reads:

  python -m vspbfr_tpu_torch.cli.convert_ckpt psp --torch style_encoder_decoder.pt --out ckpts/psp.pt
  python -m vspbfr_tpu_torch.cli.convert_ckpt diffuser --torch code_diffuser.pt --out ckpts/diffuser.pt
  python -m vspbfr_tpu_torch.cli.convert_ckpt restore --torch restoration_net.pt --out ckpts/restore.pt
  python -m vspbfr_tpu_torch.cli.convert_ckpt arcface --torch Arcface.pth --out ckpts/arcface.pt
  python -m vspbfr_tpu_torch.cli.convert_ckpt lpips --torch vgg16_torchvision.pth \\
      --lin my_lpips/weights/v0.1/vgg.pth --out ckpts/lpips.pt
  python -m vspbfr_tpu_torch.cli.convert_ckpt inception --torch inception_v3_torchvision.pth \\
      --out ckpts/inception.pt

  psp        the PSPFacade state_dict         --psp_ckpt (both trainer CLIs)
  diffuser   {"diffuser": state_dict}         --diffuser_ckpt (train_restore)
  restore    {"g", "g_ema", "d"} state_dicts  (as the JAX CLI writes them)
  arcface    the ResNet101Embedder state_dict --arcface_ckpt
  lpips      the LPIPS state_dict             --lpips_ckpt
  inception  the InceptionV3Features one      --inception_ckpt (cli/infer.py)

The psp file has no mapping MLP, as the trainer CLIs' PSPFacade has
none; `convert.convert_psp_checkpoint(PSPFacade(mapping=True), path)`
keeps the reference decoder's for `mean_latent` / `noise_mapping`. A
serving checkpoint for `cli/infer.py --ckpt` is the pipeline's
state_dict: `psp.*`, `diffuser.*` and `generator.*` (from `g_ema`) of
these files. Checkpoint layouts per `restoration_test.py:31-40`,
`:239-250`, `e4e/models/psp.py:122-143`, `Loss/id_loss.py:13-15` upstream.

The modules are built on the CPU and nothing is computed on a device, so
there is no `--device` and CUDA is never touched. The reference files hold
non-tensor entries (options, optimizer states) and are unpickled in full
(`torch.load(weights_only=False)`): convert only files you trust.
"""

from __future__ import annotations

import argparse

from vspbfr_tpu_torch.cli.common import tiny_pipeline_kwargs
from vspbfr_tpu_torch.convert import torch_import as ti
from vspbfr_tpu_torch.utils import save_checkpoint

KINDS = ("psp", "diffuser", "restore", "arcface", "lpips", "inception")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("kind", choices=KINDS)
    p.add_argument("--torch", dest="torch_path", required=True,
                   help="the reference's file (a trusted source only)")
    p.add_argument("--lin", default=None,
                   help="LPIPS lin weights (lpips only)")
    p.add_argument("--out", required=True, help="port file to write")
    p.add_argument("--size", type=int, default=512,
                   help="pipeline resolution (RestoreNet, D, psp out_size)")
    p.add_argument("--decoder_size", type=int, default=1024,
                   help="StyleGAN2 decoder resolution (psp)")
    p.add_argument("--tiny", action="store_true",
                   help="test-size networks (the trainer CLIs' --tiny)")
    return p


def convert(args) -> dict:
    """The port tree `args` asks for (see the module docstring)."""
    from vspbfr_tpu_torch.models import (
        CodeDiffuser,
        Discriminator,
        PSPFacade,
        RestorationNet,
    )

    tiny = tiny_pipeline_kwargs(args.tiny)
    if args.kind == "psp":
        psp = PSPFacade(out_size=args.size, size=args.decoder_size, **tiny)
        return ti.convert_psp_checkpoint(psp, args.torch_path)
    if args.kind == "diffuser":
        sd = ti.load_torch_state_dict(args.torch_path)
        if any(k.startswith("att_mapper.att_mapper") for k in sd):
            sd = ti.sub_state_dict(sd, "att_mapper")
        # the file stores {"att_mapper": state_dict}
        # (`restoration_test.py:31-40`)
        if "att_mapper" in sd and not hasattr(sd["att_mapper"], "shape"):
            sd = dict(sd["att_mapper"])
        return {"diffuser": ti.convert_code_diffuser(CodeDiffuser(), sd)}
    if args.kind == "restore":
        raw = ti.load_torch_state_dict(args.torch_path)
        div = tiny.get("channel_div", 1)
        out = {}
        for name in ("g", "g_ema", "d"):
            if not isinstance(raw.get(name), dict):
                continue
            if name == "d":
                out["d"] = ti.convert_discriminator(
                    Discriminator(size=args.size, channel_div=div), raw["d"],
                    size=args.size)
            else:
                out[name] = ti.convert_restoration_net(
                    RestorationNet(size=args.size, channel_div=div),
                    raw[name])
        if not out:
            raise KeyError(f"{args.torch_path}: no g, g_ema or d state_dict")
        return out
    from vspbfr_tpu_torch.losses import (
        LPIPS,
        InceptionV3Features,
        ResNet101Embedder,
    )

    sd = ti.load_torch_state_dict(args.torch_path)
    if args.kind == "arcface":
        return ti.convert_resnet101(ResNet101Embedder(), sd)
    if args.kind == "lpips":
        if args.lin is None:
            raise ValueError("lpips needs --lin (the calibrated lin heads)")
        return ti.convert_lpips(LPIPS(), sd,
                                ti.load_torch_state_dict(args.lin))
    return ti.convert_inception_v3(InceptionV3Features(), sd)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    save_checkpoint(args.out, convert(args))
    print(f"converted {args.kind} -> {args.out}")


if __name__ == "__main__":
    main()
