"""Plain PyTorch references, one module per configuration program. They
import nothing of `neptune_tpu_torch` and take nothing it made."""
