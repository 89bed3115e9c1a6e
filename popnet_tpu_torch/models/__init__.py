from popnet_tpu_torch.models.rtpose_light3d import RTPoseLight3D

__all__ = ["RTPoseLight3D"]
