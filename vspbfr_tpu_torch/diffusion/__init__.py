from vspbfr_tpu_torch.diffusion.ddpm import DDPMSchedule, LatentDDPM

__all__ = ["DDPMSchedule", "LatentDDPM"]
