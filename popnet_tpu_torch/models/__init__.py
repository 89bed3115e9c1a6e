from popnet_tpu_torch.models.a2j import A2J
from popnet_tpu_torch.models.popnet import PopNet, PopNetRGB
from popnet_tpu_torch.models.rtpose_align3d import RTPoseAlign3D
from popnet_tpu_torch.models.rtpose_light import RTPoseLight
from popnet_tpu_torch.models.rtpose_light3d import RTPoseLight3D
from popnet_tpu_torch.models.rtpose_vgg import RTPoseVGG
from popnet_tpu_torch.models.yolo_posenet import YoloPoseNet

__all__ = ["A2J", "PopNet", "PopNetRGB", "RTPoseAlign3D", "RTPoseLight", "RTPoseLight3D", "RTPoseVGG",
           "YoloPoseNet"]
