"""Stage-2 trainer: code-diffuser training (the reference's
`code_diffuser_train.py`).

Counterpart of `vspbfr_tpu/train/diffuser_train.py`. One step:

    low_latent = E(low); target = E(real)      frozen encodes (no graph)
    pred, chain = training_chain(low_latent)   4-step reverse chain WITH
                                               grads, from the low latent
                                               noised to t = T-1
    loss = L1(chain[-1], target)               the only latent term (Q3: the
                                               KD-KL is logged, not optimised)
         + 0.1 * LPIPS(decode(pred), real).mean()   grads flow THROUGH the
         + 0.1 * ID(decode(pred), real)             frozen StyleGAN2 decoder
    Adam(lr * 0.8, betas (0, 0.99^0.8)) on the diffuser's parameters only.

The psp (encoder, decoder, latent_avg), LPIPS and ID nets are frozen with
`requires_grad_(False)`; gradients reach the diffuser through the decoder's
activations. On the card that backward runs K1's gradient and the K4
phase gather of every subpixel up-conv.

Dtype islands: the encodes, the DDPM chain and the L1 target are f32;
`compute_dtype="bfloat16"` runs the decode (forward and backward) in bf16 on
a bf16 copy of the frozen decoder, and with `bf16_loss_nets` the LPIPS and
ID trunks too; the decoded image returns to f32 for the loss nets.

Randomness: the DDPM noise and the decoder's noise maps are drawn from an
explicit `torch.Generator` before the decode (or handed in as `draws`), so
a rematerialised decode (`remat`, `torch.utils.checkpoint`) recomputes
with the same noise.

Data parallelism (`parallel.DataParallel`, one rank per process): each
rank takes `batch` rows and draws the global batch's noise from one
identically seeded generator, keeping its own rows; the gradients are
averaged over the ranks once per step, after the `grad_accum`
microbatches, and the metrics come back as global means. So a world-2
step at `batch` rows a rank computes the world-1 step at the global batch.

On a 2-D data x model mesh (`shard_model`): the data axis as above, over
its sub-group; on the model axis every module's weights that
`model_param_specs` names (the diffuser's and the frozen psp's, LPIPS's and
ID's) are sharded at rest and gathered at use (`parallel/model_axis.py`),
so Adam keeps the diffuser's moments at 1/n_model of those parameters'
size, and the decode's maps are H-sharded (`parallel/spatial.py`): each
rank decodes its rows of the image, forward and backward (its noise the
global draw's rows, so the rematerialised decode draws and exchanges the
same), the image is gathered whole for LPIPS and ID, and the codes'
gradient, each rank's rows' part, is summed over the model axis once.
The ranks of one model group take the same batch rows and compute the
same step.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from vspbfr_tpu_torch.diffusion import LatentDDPM
from vspbfr_tpu_torch.losses import LPIPS, ResNet101Embedder, id_loss, kd_loss
from vspbfr_tpu_torch.models.layers import init_module
from vspbfr_tpu_torch.parallel import DataParallel, Spatial
from vspbfr_tpu_torch.parallel.model_axis import shard_module
from vspbfr_tpu_torch.pipeline import RestorationPipeline
from vspbfr_tpu_torch.train.state import TrainState

METRICS = ("l1", "kl", "percept", "id")


@dataclasses.dataclass(frozen=True)
class DiffuserTrainConfig:
    """Defaults = `code_diffuser_train.py:249-273` upstream (+ the 0.1
    weights it hardcodes)."""

    size: int = 256             # eval/decode size
    batch: int = 16             # per-device
    lr: float = 0.002
    reg_every: int = 4          # optimizer ratio only
    percept_weight: float = 0.1
    id_weight: float = 0.1
    kd_temperature: float = 0.15
    timesteps: int = 4
    # rematerialise the decode forward inside the backward; None = on in
    # f32, off with a compute_dtype (the JAX package's choice)
    remat: bool | None = None
    # split each step's batch into grad_accum sequential microbatches and
    # average their gradients before the one Adam update (every loss term
    # is a mean, so this is the full-batch gradient)
    grad_accum: int = 1
    # "bfloat16": the image-space decode (forward and backward) in bf16;
    # the encodes, the DDPM chain and the L1 target stay f32
    compute_dtype: str | None = None
    # bf16 LPIPS/ID trunks with f32 heads, only with compute_dtype
    bf16_loss_nets: bool = True


class DiffuserTrainer:
    """Owns the frozen psp (from `pipeline`), the trained diffuser, the loss
    nets and the diffuser's `TrainState`. Only `pipeline.psp` and
    `pipeline.diffuser` are used (RestoreNet is not trained here)."""

    def __init__(self, config: DiffuserTrainConfig,
                 pipeline: RestorationPipeline | None = None,
                 dp: DataParallel | None = None):
        self.cfg = config
        self.dp = dp or DataParallel()
        self.pipe = pipeline or RestorationPipeline(
            size=config.size, timesteps=config.timesteps)
        self.compute_dtype = (getattr(torch, config.compute_dtype)
                              if config.compute_dtype else None)
        ln_dt = self.compute_dtype if config.bf16_loss_nets else None
        self.psp = self.pipe.psp
        self.diffuser = self.pipe.diffuser
        self.lpips = LPIPS(compute_dtype=ln_dt)
        self.id_net = ResNet101Embedder(compute_dtype=ln_dt)
        for m in (self.psp, self.lpips, self.id_net):
            m.requires_grad_(False)
        self.ddpm = LatentDDPM(self.diffuser, self.pipe.schedule)
        self.state = TrainState(self.diffuser, config.lr, config.reg_every,
                                self.dp)
        self._decoder_c = None
        self.spatial = None     # the decode's H-sharding (`shard_model`)

    @property
    def modules(self) -> dict:
        return {"psp": self.psp, "diffuser": self.diffuser,
                "lpips": self.lpips, "id": self.id_net}

    def init_from_seed(self, seed: int) -> "DiffuserTrainer":
        """Random weights with the JAX package's init distributions, drawn
        on the CPU from `seed`: psp and diffuser as
        `RestorationPipeline.init_from_seed(seed)` draws them, then LPIPS
        and ID."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules.values():
            init_module(m, gen)
        return self

    def to(self, device) -> "DiffuserTrainer":
        for m in self.modules.values():
            m.to(device)
        self._decoder_c = None
        return self

    def shard_model(self, mesh) -> "DiffuserTrainer":
        """Place the trainer on a 2-D mesh (`parallel.create_mesh_2d`): the
        data axis reduces the gradients and metrics (`DataParallel(mesh)`),
        the model axis shards every module's weights by
        `model_param_specs` and the decode's maps by rows
        (`Spatial.from_mesh`), and the diffuser's `TrainState` is made anew
        over the slices. After the weights are set (init or load) and the
        modules moved, before the first step. Either layout: at
        packed_min_res > 0 the packed levels' maps are sharded by packed
        rows, and their gradients flow back through the same exchanges."""
        self.dp = DataParallel(mesh)
        self.spatial = Spatial.from_mesh(mesh)
        for m in self.modules.values():
            shard_module(m, mesh)
        self.state = TrainState(self.diffuser, self.cfg.lr,
                                self.cfg.reg_every, self.dp, self.spatial)
        self._decoder_c = None
        return self

    @property
    def device(self) -> torch.device:
        return self.psp.latent_avg.device

    def decoder(self):
        """The decoder the loss decodes with: the psp's own, or in
        compute_dtype a frozen copy of it cast once (the psp keeps its f32
        weights for export and samples)."""
        if self.compute_dtype is None:
            return self.psp.decoder
        if self._decoder_c is None:
            self._decoder_c = copy.deepcopy(self.psp.decoder).to(
                self.compute_dtype)
        return self._decoder_c

    def draw(self, batch: int, generator: torch.Generator) -> dict:
        """The random draws of this rank's `batch` rows: the DDPM noise (B,
        n_latent, 512) and the decoder's noise maps (packed at the packed
        resolutions, `Generator.noise_shapes`), all f32 N(0, 1), drawn
        for the global batch (batch x world size) and cut to the rank's
        rows."""
        dev = self.device
        n_lat = self.psp.n_latent
        n = batch * self.dp.world_size
        rows = self.dp.local_rows(n)

        def randn(shape):
            return torch.randn(shape, generator=generator,
                               device=dev)[rows]

        return {"init_noise": randn((n, n_lat, 512)),
                "noise": [randn(s) for s in
                          self.psp.decoder.noise_shapes(n)]}

    def _decode(self, latent: torch.Tensor, *noise) -> torch.Tensor:
        """The pooled decode of the latent, whole, returned in the latent's
        dtype (f32: a bf16 decode returns to f32 for the loss nets); on a
        mesh H-sharded, then gathered."""
        dec = self.decoder()
        dt = self.compute_dtype
        out_dtype = latent.dtype
        if dt is not None:
            latent = latent.to(dt)
            noise = [n.to(dt) for n in noise]
        image = self.psp.decode(latent, noise=list(noise), decoder=dec,
                                spatial=self.spatial)
        if self.spatial is not None:
            image = self.spatial.gather(image)
        return image.to(out_dtype)

    def losses(self, low: torch.Tensor, real: torch.Tensor, draws: dict):
        """The forward of one (micro)batch: (loss, metrics), the loss with
        its graph back to the diffuser's parameters."""
        cfg = self.cfg
        low_latent = self.psp.get_w_plus(low)
        target = self.psp.get_w_plus(real)
        pred, chain = self.ddpm.training_chain(low_latent, low_latent,
                                               draws["init_noise"])
        kl, l1 = kd_loss(chain[-1], target, cfg.kd_temperature)
        loss = l1
        percept = ident = torch.zeros((), device=low.device)
        if cfg.percept_weight > 0 or cfg.id_weight > 0:
            do_remat = (cfg.remat if cfg.remat is not None
                        else cfg.compute_dtype is None)
            if do_remat:
                restored = checkpoint(self._decode, pred, *draws["noise"],
                                      use_reentrant=False)
            else:
                restored = self._decode(pred, *draws["noise"])
            if cfg.percept_weight > 0:
                percept = (torch.mean(self.lpips(restored, real))
                           * cfg.percept_weight)
            if cfg.id_weight > 0:
                ident = id_loss(self.id_net, restored, real) * cfg.id_weight
            loss = loss + percept + ident
        return loss, {"l1": l1, "kl": kl, "percept": percept, "id": ident}

    def loss_and_grads(self, low: torch.Tensor, real: torch.Tensor,
                       draws: dict, grad_scale: float = 1.0):
        """Forward and backward of one (micro)batch: adds grad_scale times
        the diffuser's gradients into its `.grad`; returns the loss and the
        metrics, detached."""
        loss, metrics = self.losses(low, real, draws)
        (loss * grad_scale).backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(self, low: torch.Tensor, real: torch.Tensor,
                   generator: torch.Generator | None = None,
                   draws: dict | None = None) -> dict:
        """One Adam update from the batch, in `grad_accum` microbatches.
        The draws come from `generator` per microbatch, or from `draws`
        (whole-batch tensors, split along the batch). Returns the metrics
        averaged over the microbatches and the ranks, as 0-d tensors."""
        a = self.cfg.grad_accum
        b = low.shape[0]
        if b % a:
            raise ValueError(f"batch {b} not divisible by grad_accum {a}")
        mb = b // a
        self.state.opt.zero_grad(set_to_none=True)
        total = {k: 0.0 for k in ("loss",) + METRICS}
        for i in range(a):
            sl = slice(i * mb, (i + 1) * mb)
            if draws is None:
                d = self.draw(mb, generator)
            else:
                d = {"init_noise": draws["init_noise"][sl],
                     "noise": [n[sl] for n in draws["noise"]]}
            loss, metrics = self.loss_and_grads(low[sl], real[sl], d,
                                                grad_scale=1.0 / a)
            for k, v in (("loss", loss), *metrics.items()):
                total[k] = total[k] + v / a
        self.state.apply_gradients()
        return self.dp.mean_metrics(total)
