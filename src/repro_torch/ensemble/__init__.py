from repro_torch.ensemble.boxes import Detections, iou_matrix  # noqa: F401
from repro_torch.ensemble.voting import (group_detections,  # noqa: F401
                                         vote_filter)
from repro_torch.ensemble.ablation import nms, soft_nms, wbf  # noqa: F401
from repro_torch.ensemble.pipeline import (  # noqa: F401
    PATHWAYS, ensemble_detections, ensemble_detections_batch,
    ensemble_from_arrays)
from repro_torch.ensemble.metrics import (  # noqa: F401
    ap50, average_precision, coco_map, image_ap50)
