"""Stage-3 trainer: RestoreNet GAN training (the reference's
`restoration_train.py`).

Counterpart of `vspbfr_tpu/train/restore_train.py` on one device. One
step (`train_step`):

    clean, feats = embedding(low)   frozen: encode -> 4-step DDPM -> decode
                                    features (no graph), shared by both phases
    D phase: fake = G(low, feats, clean) without a graph; softplus loss on
             (D(real), D(fake)); Adam. Lazy R1 when the G step count is a
             multiple of d_reg_every: a second D update on
             r1/2 * E||dD(real)/dreal||^2 * d_reg_every
    G phase: a fresh fake; non-saturating loss + mean(LPIPS) * batch *
             percept_weight + ID * id_weight, against the updated D; Adam
             on G only; then the EMA of G.

`d_phase` and `g_phase` take the embedding as arguments (the JAX d_phase
computes it and hands it on), so a test can give both frameworks the same
one.

Randomness is explicit (`draw`): the DDPM noise and the decoder's noise
maps of the embedding, and per generator call the mixing draws (z, inject
index), RestoreNet's noise maps and the encoder head's dropout keep mask,
all drawn from one `torch.Generator` before any checkpointed call, or
handed in. The JAX package draws them from its key inside the step; the
two streams differ, the distributions are the same.

Data parallelism (`parallel.DataParallel`, one rank per process): each
rank takes `batch` rows; the gradients are averaged over the ranks in
each `TrainState.apply_gradients` (D, R1's second D update, G), ADA's
controller sums its statistics over them and the metrics come back as
global means. Every rank draws the global batch's draws from one
identically seeded generator and keeps its own rows, so the ranks' streams
stay in lockstep and a world-2 step draws what a world-1 step at the
global batch draws. The LPIPS term stays mean * the per-rank batch.
`minibatch_stddev` in D groups the rank's own rows, as under the
reference's DDP (the JAX package's sharded step groups the global batch).

On a 2-D data x model mesh (`shard_model`, as JAX places a TrainState
with `model_param_specs`): the data axis as above, over its sub-group;
on the model axis every module's weights that `model_param_specs` names
(G, D, g_ema and the frozen nets) are sharded at rest and gathered at use
(`parallel/model_axis.py`), so both Adams keep 1/n_model of those
parameters' moments and the EMA runs over the slices; the frozen
embedding's decode and RestoreNet's forward and backward run on this
rank's rows of the H-sharded maps (`parallel/spatial.py`), the fake
images gathered whole for D, ADA, LPIPS and ID. D, lazy R1 and ADA run on
whole images, so D's gradients (R1's double backward too, through the
gathers' `narrow`) are whole on every rank and not summed; G's row parts
are summed over the model axis (its styles once a forward, its
model-sharded weights by reduce-scatter in the backward, its replicated
ones after it). Checkpoints hold the unsharded tensors.

Remat (`torch.utils.checkpoint`, non-reentrant, so R1's double backward
runs through it) wraps the G and D forwards; automatic as in JAX: on in
f32, off with a compute_dtype.

Dtype islands (`compute_dtype="bfloat16"`): G and D compute in bf16 on
their f32 parameters, cast inside each call (`torch.func.functional_call`),
so the gradients, both Adam states and the EMA stay f32; the generated
image and D's logits return in f32, so the losses, their reductions and R1
are f32. With `bf16_embed` the frozen decode of the embedding runs on a
bf16 copy of the decoder (encode and DDPM stay f32); with `bf16_loss_nets`
the LPIPS and ID trunks run bf16.

ADA (`augment`; `losses/ada.py`), as `vspbfr_tpu/train/restore_train.py`
runs it: the D phase augments the real and the fake images at p_eff (a
fixed `augment_p` > 0, else the controller's p), feeds the controller
with D's real logits from before the update (`augment_p` 0 only), and
augments R1's batch afresh inside the function whose input gradient R1
takes; the G phase augments the fake before D at the controller's updated
p. The augment runs in f32 on the f32 images G and D exchange, in either
compute dtype; its draws are part of `draw`, so remat recomputes the same
augment.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from vspbfr_tpu_torch.diffusion import LatentDDPM
from vspbfr_tpu_torch.losses import (
    LPIPS,
    ADAState,
    ResNet101Embedder,
    d_logistic_loss,
    g_nonsaturating_loss,
    id_loss,
    ada_update,
    augment,
    draw_augment,
    r1_penalty,
)
from vspbfr_tpu_torch.models.layers import init_module
from vspbfr_tpu_torch.parallel import DataParallel, Spatial
from vspbfr_tpu_torch.parallel.model_axis import shard_module
from vspbfr_tpu_torch.pipeline import RestorationPipeline
from vspbfr_tpu_torch.train.state import (
    EMA_DECAY_DEFAULT,
    TrainState,
    ema_update,
)

D_METRICS = ("d", "r1", "real_score", "fake_score")
G_METRICS = ("g", "gan", "percept", "id")


@dataclasses.dataclass(frozen=True)
class RestoreTrainConfig:
    """Defaults = `restoration_train.py:310-342` upstream + its hardcoded
    post-parse values, as the JAX package's config."""

    size: int = 512
    batch: int = 4              # per device
    lr: float = 0.002
    r1: float = 10.0
    d_reg_every: int = 16
    g_reg_every: int = 4        # optimiser ratio only (no path regulariser)
    percept_weight: float = 0.5
    id_weight: float = 0.1
    mixing: float = 0.5
    ema_decay: float = EMA_DECAY_DEFAULT
    augment: bool = False       # ADA, off by default
    # fixed augment probability; 0 = adaptive (the reference's --augment_p,
    # `restoration_train.py:138-141` upstream: > 0 turns the controller off)
    augment_p: float = 0.0
    ada_target: float = 0.6
    ada_length: int = 500 * 1000
    # rematerialise the G and D forwards inside the backward; None = on in
    # f32, off with a compute_dtype (the JAX package's choice)
    remat: bool | None = None
    # "bfloat16": G and D compute in bf16 with f32 islands (see the module
    # docstring); None = f32, the reference's training dtype
    compute_dtype: str | None = None
    bf16_embed: bool = True
    bf16_loss_nets: bool = True


class RestoreTrainer:
    """Owns the pipeline (frozen psp and diffuser, the trained generator),
    the discriminator, the EMA generator, the loss nets and both
    `TrainState`s."""

    def __init__(self, config: RestoreTrainConfig,
                 pipeline: RestorationPipeline | None = None,
                 dp: DataParallel | None = None):
        self.cfg = config
        self.dp = dp or DataParallel()
        self.pipe = pipeline or RestorationPipeline(
            size=config.size, mixing_prob=config.mixing)
        self.dt = (getattr(torch, config.compute_dtype)
                   if config.compute_dtype else None)
        ln_dt = self.dt if config.bf16_loss_nets else None
        self.psp, self.diffuser = self.pipe.psp, self.pipe.diffuser
        self.gen = self.pipe.generator
        self.disc = self.pipe.make_discriminator()
        self.g_ema = copy.deepcopy(self.gen)
        self.lpips = LPIPS(compute_dtype=ln_dt)
        self.id_net = ResNet101Embedder(compute_dtype=ln_dt)
        for m in (self.psp, self.diffuser, self.g_ema, self.lpips,
                  self.id_net):
            m.requires_grad_(False)
        self.ddpm = LatentDDPM(self.diffuser, self.pipe.schedule)
        self.g_state = TrainState(self.gen, config.lr, config.g_reg_every,
                                  self.dp)
        self.d_state = TrainState(self.disc, config.lr, config.d_reg_every,
                                  self.dp)
        self._decoder_c = None
        self.spatial = None     # the maps' H-sharding (`shard_model`)
        # the controller's state (0-d tensors on the trainer's device)
        self.ada_state = ADAState.create() if config.augment else None

    @property
    def modules(self) -> dict:
        return {"psp": self.psp, "diffuser": self.diffuser,
                "generator": self.gen, "g_ema": self.g_ema,
                "disc": self.disc, "lpips": self.lpips, "id": self.id_net}

    def init_from_seed(self, seed: int) -> "RestoreTrainer":
        """Random weights with the JAX package's init distributions, drawn
        on the CPU from `seed`; the EMA starts as a copy of G. A loss net
        whose weight is 0 is not initialised (nor used), as in JAX."""
        gen = torch.Generator().manual_seed(seed)
        skip = {"g_ema"}
        if self.cfg.percept_weight <= 0:
            skip.add("lpips")
        if self.cfg.id_weight <= 0:
            skip.add("id")
        for name, m in self.modules.items():
            if name not in skip:
                init_module(m, gen)
        self.sync_ema()
        return self

    def sync_ema(self) -> None:
        """g_ema <- G (the JAX init returns G's parameters as g_ema)."""
        self.g_ema.load_state_dict(self.gen.state_dict())

    def replicate(self) -> "RestoreTrainer":
        """Rank 0's G, D and g_ema on every rank (the frozen stages are
        drawn from the same seed or read from the same file)."""
        for m in (self.gen, self.disc, self.g_ema):
            self.dp.replicate(m)
        return self

    def to(self, device) -> "RestoreTrainer":
        for m in self.modules.values():
            m.to(device)
        self._decoder_c = None
        if self.ada_state is not None:
            self.ada_state = self.ada_state.to(device)
        return self

    def shard_model(self, mesh) -> "RestoreTrainer":
        """Place the trainer on a 2-D mesh (`parallel.create_mesh_2d`): the
        data axis reduces the gradients, ADA's sums and the metrics
        (`DataParallel(mesh)`), the model axis shards every module's
        weights by `model_param_specs` and the embedding's and G's maps by
        rows (`Spatial.from_mesh`), and both `TrainState`s are made anew
        over the slices. After the weights are set (init or load, and
        `sync_ema`) and the modules moved, before the first step. Either
        layout: at packed_min_res > 0 the decoder's and G's packed levels
        are sharded by packed rows, and G's gradients flow back through
        the same exchanges."""
        cfg = self.cfg
        self.dp = DataParallel(mesh)
        self.spatial = Spatial.from_mesh(mesh)
        for m in self.modules.values():
            shard_module(m, mesh)
        self.g_state = TrainState(self.gen, cfg.lr, cfg.g_reg_every,
                                  self.dp, self.spatial)
        self.d_state = TrainState(self.disc, cfg.lr, cfg.d_reg_every,
                                  self.dp)
        self._decoder_c = None
        return self

    @property
    def device(self) -> torch.device:
        return self.psp.latent_avg.device

    @property
    def remat(self) -> bool:
        if self.cfg.remat is not None:
            return self.cfg.remat
        return self.dt is None

    # -- draws ---------------------------------------------------------------

    def _decoder_noise_shapes(self, batch: int) -> list[tuple]:
        """The noise shapes of the decoder layers the embedding runs (up to
        the up-conv at out_size): conv1 at 4, then two per level, one at
        out_size; packed at the packed resolutions."""
        n = 2 * int(math.log2(self.psp.out_size)) - 4
        return self.psp.decoder.noise_shapes(batch)[:n]

    def draw(self, batch: int, generator: torch.Generator) -> dict:
        """One step's random draws for this rank's `batch` rows, all f32
        N(0, 1) unless said: "embed": the DDPM noise and the decoder's
        noise maps; "gen_d" and "gen_g", one per generator call: z (2, B,
        512), the inject index (a Bernoulli(mixing) coin, then uniform in
        [1, n_latent), else n_latent), RestoreNet's noise maps and the
        dropout keep mask. With ADA each phase's dict also holds "ada", the
        `draw_augment` draws of its augment calls: the D phase's real, fake
        and R1 batch, the G phase's fake. Each per-sample draw is drawn for
        the global batch (batch x world size) and cut to the rank's rows;
        the scalars (the coin, the index) are shared."""
        dev = self.device
        g = self.gen
        n = batch * self.dp.world_size
        rows = self.dp.local_rows(n)

        def mine(t, dim=0):
            return t.narrow(dim, rows.start, batch).contiguous()

        def randn(shape, dim=0):
            return mine(torch.randn(shape, generator=generator, device=dev),
                        dim)

        def gen_draws():
            z = randn((2, n, self.pipe.style_dim), dim=1)
            mix = bool(torch.rand((), generator=generator, device=dev)
                       < self.pipe.mixing_prob)
            pick = int(torch.randint(1, g.n_latent, (), generator=generator,
                                     device=dev))
            return {"z": z, "inject_index": pick if mix else g.n_latent,
                    "noise": [randn(s) for s in g.noise_shapes(n)],
                    "keep": mine(g.draw_dropout_mask(n, generator, dev))}

        out = {"embed": {
                   "init_noise": randn((n, self.psp.n_latent, 512)),
                   "noise": [randn(s)
                             for s in self._decoder_noise_shapes(n)]},
               "gen_d": gen_draws(), "gen_g": gen_draws()}
        if self.cfg.augment:
            def aug():
                # every ADA draw has the batch on its last axis
                return {k: {name: mine(v, v.dim() - 1)
                            for name, v in part.items()}
                        for k, part in draw_augment(n, generator,
                                                    dev).items()}

            out["gen_d"]["ada"] = {"real": aug(), "fake": aug(), "r1": aug()}
            out["gen_g"]["ada"] = {"fake": aug()}
        return out

    # -- pieces --------------------------------------------------------------

    def _in_dtype(self, module, *args, **kw):
        """module(*args, **kw) in compute_dtype: the f32 parameters and the
        floating tensor arguments are cast inside the call, so gradients
        return to the parameters in f32."""
        if self.dt is None:
            return module(*args, **kw)
        dt = self.dt

        def cast(v):
            if isinstance(v, torch.Tensor):
                return v.to(dt) if v.is_floating_point() else v
            if isinstance(v, (list, tuple)):
                return type(v)(cast(a) for a in v)
            if isinstance(v, dict):
                return {k: cast(a) for k, a in v.items()}
            return v

        params = {k: cast(v) for k, v in module.named_parameters()}
        return functional_call(module, params, cast(args), cast(kw))

    def decoder(self):
        """The decoder of the embedding: the psp's own, or with
        compute_dtype and bf16_embed a copy cast once."""
        if self.dt is None or not self.cfg.bf16_embed:
            return self.psp.decoder
        if self._decoder_c is None:
            self._decoder_c = copy.deepcopy(self.psp.decoder).to(self.dt)
        return self._decoder_c

    @torch.no_grad()
    def embedding(self, low: torch.Tensor, draws: dict):
        """The frozen embedding shared by both phases
        (`restoration_train.py:166-172` upstream): the clean W+ code (f32)
        and the decoder features RestoreNet fuses."""
        low_latent = self.psp.get_w_plus(low)
        clean = self.ddpm.sample(low_latent, draws["init_noise"])
        dec = self.decoder()
        dt = next(dec.parameters()).dtype
        _, feats = self.psp.decode_with_feats(
            clean.to(dt), return_image=False, decoder=dec,
            noise=[n.to(dt) for n in draws["noise"]], spatial=self.spatial)
        return clean, feats

    def generate(self, low, feats, clean, draws: dict) -> torch.Tensor:
        """RestoreNet in training mode (noise, dropout) on the draws;
        returns the image in f32, whole (on a mesh: gathered from the
        ranks' rows). The mixing latent runs in f32 outside the
        rematerialised call, as in JAX."""
        noise_latent = self.gen.map_styles(draws["z"], draws["inject_index"])
        nf = len(feats)

        def fwd(low, clean, noise_latent, *maps):
            out = self._in_dtype(
                self.gen, low, list(maps[:nf]), clean, noise_latent,
                input_is_latent=True, noise=list(maps[nf:]),
                dropout_mask=draws["keep"], spatial=self.spatial)
            if self.spatial is not None:
                out = self.spatial.gather(out)
            return out.float()

        args = (low, clean, noise_latent, *feats, *draws["noise"])
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fwd, *args, use_reentrant=False)
        return fwd(*args)

    def disc_logits(self, x: torch.Tensor) -> torch.Tensor:
        """D's (B, 1) logits in f32."""
        def fwd(x):
            return self._in_dtype(self.disc, x).float()

        if self.remat and torch.is_grad_enabled():
            return checkpoint(fwd, x, use_reentrant=False)
        return fwd(x)

    def ada_p(self) -> torch.Tensor:
        """The augment probability now, a 0-d tensor on the device: the
        fixed `augment_p` when > 0, else the controller's p."""
        if self.cfg.augment_p > 0:
            return torch.full((), self.cfg.augment_p, device=self.device)
        return self.ada_state.p

    # -- phases --------------------------------------------------------------

    def d_phase(self, low, real, clean, feats, draws: dict) -> dict:
        """The D update (with ADA on augmented images, then the
        controller's update), then the lazy R1 update when the G step count
        is a multiple of d_reg_every (`restoration_train.py:164-216`)."""
        cfg = self.cfg
        with torch.no_grad():
            fake = self.generate(low, feats, clean, draws)
        real_d, d_apply = real, self.disc_logits
        if cfg.augment:
            aug, p = draws["ada"], self.ada_p()
            real_d, fake = (augment(real, aug["real"], p),
                            augment(fake, aug["fake"], p))

            def d_apply(x):
                return self.disc_logits(augment(x, aug["r1"], p))
        real_pred = self.disc_logits(real_d)
        fake_pred = self.disc_logits(fake)
        d_loss = d_logistic_loss(real_pred, fake_pred)
        self.d_state.opt.zero_grad(set_to_none=True)
        d_loss.backward()
        self.d_state.apply_gradients()
        if cfg.augment and cfg.augment_p == 0:
            self.ada_state = ada_update(self.ada_state, real_pred.detach(),
                                        cfg.ada_target, cfg.ada_length,
                                        all_sum=self.dp.sum_)
        r1 = torch.zeros((), device=real.device)
        if self.g_state.step % cfg.d_reg_every == 0:
            pen = r1_penalty(d_apply, real)
            (cfg.r1 / 2.0 * pen * cfg.d_reg_every).backward(
                inputs=list(self.disc.parameters()))
            self.d_state.apply_gradients()
            r1 = pen.detach()
        out = {"d": d_loss.detach(), "r1": r1,
               "real_score": real_pred.detach().mean(),
               "fake_score": fake_pred.detach().mean()}
        if cfg.augment:
            # the controller's signal for this batch (`non_leaking.py:499-504`)
            out["ada_rt"] = torch.sign(real_pred.detach()).mean()
        return out

    def g_loss(self, low, real, clean, feats, draws: dict):
        """(loss, metrics) of the G phase (`restoration_train.py:221-249`),
        the loss with its graph back to G's parameters. The LPIPS term is
        mean * cfg.batch, the reference's per-GPU sum."""
        cfg = self.cfg
        fake = self.generate(low, feats, clean, draws)
        fake_d = fake
        if cfg.augment:
            fake_d = augment(fake, draws["ada"]["fake"], self.ada_p())
        gan = g_nonsaturating_loss(self.disc_logits(fake_d))
        percept = ident = torch.zeros((), device=real.device)
        if cfg.percept_weight > 0:
            percept = (torch.mean(self.lpips(fake, real)) * cfg.batch
                       * cfg.percept_weight)
        if cfg.id_weight > 0:
            ident = id_loss(self.id_net, fake, real) * cfg.id_weight
        loss = gan + percept + ident
        metrics = {"g": loss, "gan": gan, "percept": percept, "id": ident}
        if cfg.augment:
            metrics["ada_p"] = self.ada_p()
        return loss, metrics

    def g_phase(self, low, real, clean, feats, draws: dict) -> dict:
        """The G update against the current D, then the EMA."""
        loss, metrics = self.g_loss(low, real, clean, feats, draws)
        self.g_state.opt.zero_grad(set_to_none=True)
        loss.backward(inputs=list(self.gen.parameters()))
        self.g_state.apply_gradients()
        ema_update(self.g_ema, self.gen, self.cfg.ema_decay)
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(self, low: torch.Tensor, real: torch.Tensor,
                   generator: torch.Generator | None = None,
                   draws: dict | None = None) -> dict:
        """Embedding, D phase (with R1 when due), G phase. The draws come
        from `generator` or are handed in. Returns the metrics as 0-d
        tensors, averaged over the ranks."""
        if draws is None:
            draws = self.draw(low.shape[0], generator)
        clean, feats = self.embedding(low, draws["embed"])
        d_m = self.d_phase(low, real, clean, feats, draws["gen_d"])
        g_m = self.g_phase(low, real, clean, feats, draws["gen_g"])
        return self.dp.mean_metrics({**d_m, **g_m})

    # -- checkpoints ---------------------------------------------------------

    def export_state_dict(self) -> dict:
        """The inference-ready pipeline state_dict (`cli/infer.py --ckpt`):
        psp, diffuser, and g_ema as the generator (the reference serves
        g_ema, `restoration_test.py:239-250` upstream)."""
        sd = {k: v for k, v in self.pipe.state_dict().items()
              if not k.startswith("generator.")}
        sd.update({f"generator.{k}": v
                   for k, v in self.g_ema.state_dict().items()})
        return sd
