from vspbfr_tpu_torch.models.code_diffuser import CodeDiffuser
from vspbfr_tpu_torch.models.e4e import Encoder4Editing, GradualStyleEncoder
from vspbfr_tpu_torch.models.psp import PSPFacade
from vspbfr_tpu_torch.models.restorenet import Discriminator, RestorationNet
from vspbfr_tpu_torch.models.stylegan2 import Generator, channel_dict

__all__ = ["CodeDiffuser", "Discriminator", "Encoder4Editing", "Generator",
           "GradualStyleEncoder", "PSPFacade", "RestorationNet",
           "channel_dict"]
