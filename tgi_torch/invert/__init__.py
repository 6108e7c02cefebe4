from tgi_torch.invert.coach import CoachConfig, PTICoach  # noqa: F401
from tgi_torch.invert.projector import Projector, ProjectorConfig  # noqa: F401
from tgi_torch.invert.selfinv import (aim_pose_net,  # noqa: F401
                                      rotation_error_deg,
                                      self_inversion_eval,
                                      self_inversion_eval_batch)
