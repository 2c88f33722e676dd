"""Named model configurations of the reference's released models
(`metrabs_tpu/models/registry.py`, the port's own copy: the original
imports the JAX package's config).

Each entry maps the published model name to its backbone, crop resolution,
detector and TTA packaging flags. Weights are not bundled; the registry pins
the architecture and config side.
"""

from __future__ import annotations

import dataclasses

from metrabs_tpu_torch.config import AugConfig, ModelConfig


@dataclasses.dataclass(frozen=True)
class NamedModel:
    name: str
    backbone: str
    proc_side: int = 256
    detector: str = 'yolov4'          # 'yolov4' | 'yolov4-tiny' | ''
    rot_aug_degrees: float = 25.0
    rot_aug_360: bool = False

    def model_config(self, **overrides) -> ModelConfig:
        return ModelConfig(proc_side=self.proc_side, backbone=self.backbone, **overrides)

    def aug_config(self) -> AugConfig:
        return AugConfig(rot_aug_degrees=self.rot_aug_degrees, rot_aug_360=self.rot_aug_360)


# The released configurations: the 13 rows of the published table plus the
# 384 px EffNetV2-L serving variant.
NAMED_MODELS = {m.name: m for m in [
    NamedModel('metrabs_eff2l_y4', 'efficientnetv2-l'),
    NamedModel('metrabs_eff2l_y4_384', 'efficientnetv2-l', proc_side=384),
    NamedModel('metrabs_eff2m_y4', 'efficientnetv2-m'),
    NamedModel('metrabs_eff2s_y4', 'efficientnetv2-s'),
    NamedModel('metrabs_rn152_y4', 'resnet152'),
    NamedModel('metrabs_rn101_y4', 'resnet101'),
    NamedModel('metrabs_rn50_y4', 'resnet50'),
    NamedModel('metrabs_rn34_y4', 'resnet34'),
    NamedModel('metrabs_rn18_y4', 'resnet18'),
    NamedModel('metrabs_mob3l_y4', 'mobilenetv3-large'),
    NamedModel('metrabs_mob3s_y4', 'mobilenetv3-small'),
    NamedModel('metrabs_mob3l_y4t', 'mobilenetv3-large', detector='yolov4-tiny'),
    NamedModel('metrabs_mob3s_y4t', 'mobilenetv3-small', detector='yolov4-tiny'),
    NamedModel('metrabs_eff2l_y4_360', 'efficientnetv2-l', rot_aug_360=True),
]}


def get_named_model(name: str) -> NamedModel:
    if name not in NAMED_MODELS:
        raise KeyError(f'Unknown model {name!r}; available: {sorted(NAMED_MODELS)}')
    return NAMED_MODELS[name]
