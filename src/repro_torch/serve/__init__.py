"""serve of the PyTorch port (see repro_torch/__init__.py): the JAX
package's re-exports."""
from repro_torch.serve.engine import (  # noqa: F401
    AdmissionPolicy,
    Engine,
    EngineAPI,
    EngineRunResult,
    LMEngineCore,
    Request,
    SubmitResult,
)
from repro_torch.serve.detector import (  # noqa: F401
    CompiledDetector,
    DetectorEngineCore,
    DetectorSession,
    FrameRequest,
    SessionStep,
    StalePlanError,
)
