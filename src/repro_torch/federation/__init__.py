from repro_torch.federation import faults  # noqa: F401
from repro_torch.federation.parties import (  # noqa: F401
    DataOwner, DataScientist, OwnerComputeEndpoint, PrivacyError,
    feature_parties)
from repro_torch.federation.registry import build_adapter  # noqa: F401
from repro_torch.federation.session import VerticalSession  # noqa: F401
from repro_torch.federation.supervisor import (  # noqa: F401
    OwnerFailure, Supervisor)
from repro_torch.federation.transport import FrameCorrupt  # noqa: F401
