from popnet_tpu_torch.models.popnet import PopNet
from popnet_tpu_torch.models.rtpose_align3d import RTPoseAlign3D
from popnet_tpu_torch.models.rtpose_light3d import RTPoseLight3D

__all__ = ["PopNet", "RTPoseAlign3D", "RTPoseLight3D"]
