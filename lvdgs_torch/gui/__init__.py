"""The GUI feed (port of ``lvdgs_tpu/gui``)."""
from .gui_utils import ControlPacket, FakeQueue, GaussianPacket, HeadlessViewer, snapshot_gaussians
