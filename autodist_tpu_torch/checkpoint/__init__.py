"""Checkpointing and serving export (counterpart of
``autodist_tpu/checkpoint/``)."""
from autodist_tpu_torch.checkpoint.export import (ExportedModel, export_model,
                                                  load_exported,
                                                  load_exported_params,
                                                  parse_dtype)
from autodist_tpu_torch.checkpoint.saver import CheckpointSaveError, Saver

__all__ = ["Saver", "CheckpointSaveError", "export_model", "load_exported",
           "load_exported_params", "ExportedModel", "parse_dtype"]
