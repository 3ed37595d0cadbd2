"""ANN→SNN conversion front-end (Spiking-YOLO-style, arXiv 1903.06530).

Counterpart of ``repro/convert``: imports a pretrained dense conv+BN YOLO
detector from an ``.npz`` bundle, calibrates per-channel firing thresholds
on a ``DetectionSource`` split, and emits an ``SNNDetConfig`` + parameter
tree that drops straight into ``core/plan.build_plan`` and the
self-describing detector checkpoint format — no training steps anywhere.

    ann = convert.load_ann_npz("tests/fixtures/ann_detector/ann_tiny_yolo.npz")
    out = convert.convert_ann(ann)      # on the card; device="cpu" to ask
    out.save("/tmp/converted")          # launch.serve --checkpoint /tmp/converted
"""
from repro_torch.convert.importer import (  # noqa: F401
    FORMAT,
    AnnConvBN,
    AnnDetector,
    conv_bn_layer_names,
    export_ann_npz,
    load_ann_npz,
)
from repro_torch.convert.calibrate import (  # noqa: F401
    CalibrationStats,
    LayerStats,
    ann_reference_forward,
    calibrate,
    quantize_images_u8,
)
from repro_torch.convert.emit import (  # noqa: F401
    ConvertConfig,
    ConvertedDetector,
    convert_ann,
    readout_scale,
)
