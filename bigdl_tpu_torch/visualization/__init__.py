"""TensorBoard-compatible training visualization of the port
(``bigdl_tpu/visualization``; reference ``visualization/``: Summary,
TrainSummary and ValidationSummary over a TFRecord event writer with masked
CRC32C framing).  The event files are the JAX package's, byte for byte, and
either package's reader decodes the other's."""

from bigdl_tpu_torch.visualization.crc32c import crc32c, masked_crc32c
from bigdl_tpu_torch.visualization.file_writer import FileWriter, read_records
from bigdl_tpu_torch.visualization.proto import decode_event
from bigdl_tpu_torch.visualization.summary import (Summary, TrainSummary,
                                                   ValidationSummary,
                                                   histogram_summary,
                                                   scalar_summary)

__all__ = ["FileWriter", "Summary", "TrainSummary", "ValidationSummary",
           "crc32c", "decode_event", "histogram_summary", "masked_crc32c",
           "read_records", "scalar_summary"]
