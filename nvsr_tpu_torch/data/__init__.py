"""Dataset loaders (counterparts of nvsr_tpu/data/)."""
from nvsr_tpu_torch.data.dataset import MultiSceneDataset  # noqa: F401
from nvsr_tpu_torch.data.blender import load_blender_data  # noqa: F401
from nvsr_tpu_torch.data.llff import load_llff_data  # noqa: F401
