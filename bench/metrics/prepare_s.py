"""Host seconds the program takes, in set-up, to turn the weights it is
handed into a served detector: the plan (quantize, pack, decode), the
affine bundles and, for a converted configuration, the conversion itself
(calibration, emit, head fit)."""


def read(w):
    return w.prepare_s if w.prepare_s > 0 else None
