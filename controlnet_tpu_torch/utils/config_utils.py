"""The reference's ``utils/config_utils.py`` names, as
``controlnet_tpu/utils/config_utils.py`` exposes them; the port's
implementations live in ``controlnet_tpu_torch.config``."""

from controlnet_tpu_torch.config import (
    get_config_value,
    validate_class_conditional_input,
    validate_class_config,
    validate_image_conditional_input,
    validate_image_config,
    validate_text_config,
)

__all__ = [
    "get_config_value",
    "validate_class_config",
    "validate_text_config",
    "validate_image_config",
    "validate_image_conditional_input",
    "validate_class_conditional_input",
]
