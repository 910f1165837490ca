"""Training data: the .mel artifact dataset and its resumable samplers
(port of ``tortoise_tts_tpu/data/``)."""

from .dataset import Dataset, create_train_val_dataloader  # noqa: F401
