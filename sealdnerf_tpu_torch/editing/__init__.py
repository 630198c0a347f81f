"""Seal editing (port of sealdnerf_tpu/editing): the edit mappers, the
edit-aware teacher with the occupancy force-fill, and the student
distillation trainer.

- color_utils: RGB <-> HSV and the colour modifiers;
- geometry: the mappers' meshes (host, numpy) and point-in-mesh tests
  (samples, torch);
- seal_utils: the bbox, brush and anchor mappers and their config reader;
- teacher: make_teacher_field (a models.api Field), TeacherField (the CP
  field, through the kernels), force_fill_mask, hack_occ;
- student: StudentTrainer (the Instant-NGP and D-NeRF fields) and
  FastStudentTrainer (the CP field).
"""

from .color_utils import hsv_to_rgb, modify_hsv, modify_rgb, rgb_to_hsv
from .seal_utils import (SealAnchorMapper, SealBBoxMapper, SealBrushMapper,
                         SealMapper, get_seal_mapper, load_config)
from .teacher import (TeacherField, force_fill_mask, hack_occ,
                      make_teacher_field)

__all__ = [
    "rgb_to_hsv", "hsv_to_rgb", "modify_hsv", "modify_rgb",
    "SealMapper", "SealBBoxMapper", "SealBrushMapper", "SealAnchorMapper",
    "get_seal_mapper", "load_config",
    "TeacherField", "make_teacher_field", "force_fill_mask", "hack_occ",
]
