from fastvocoder_tpu_torch.serving.batcher import DynamicBatcher
from fastvocoder_tpu_torch.serving.model import ServingModel
from fastvocoder_tpu_torch.serving.server import make_server, run_server

__all__ = ["DynamicBatcher", "ServingModel", "make_server", "run_server"]
