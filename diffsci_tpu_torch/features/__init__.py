"""Application features over the samplers: anomaly detection (AnoDDPM,
DDAD) and RePaint inpainting."""

from diffsci_tpu_torch.features.anomaly import DDAD, AnoDDPM, AnomalyDetector
from diffsci_tpu_torch.features.inpainting import Inpainting, RePaint

__all__ = ["AnoDDPM", "AnomalyDetector", "DDAD", "Inpainting", "RePaint"]
