"""PCN benchmark models (paper Table I + §VI-D), the port's copies of
``repro.models``: name -> (module, spec)."""
from . import dgcnn, pointnet2, pointnext, pointvector
from .baselines import mesorasi_fc, mesorasi_workload  # noqa: F401
from .common import BlockSpec, PCNSpec  # noqa: F401

MODEL_ZOO = {
    "pointnet2_c": (pointnet2, pointnet2.POINTNET2_C),
    "pointnet2_ps": (pointnet2, pointnet2.POINTNET2_PS),
    "pointnet2_s": (pointnet2, pointnet2.POINTNET2_S),
    "dgcnn_c": (dgcnn, dgcnn.DGCNN_C),
    "dgcnn_s": (dgcnn, dgcnn.DGCNN_S),
    "pointnext_s": (pointnext, pointnext.POINTNEXT_S),
    "pointvector_l": (pointvector, pointvector.POINTVECTOR_L),
}
