"""Typed-config base for deepspeed_tpu_torch.

Copy of ``deepspeed_tpu/config/config_utils.py`` (the reference's pydantic
config base, ``deepspeed/runtime/config_utils.py`` — ``DeepSpeedConfigModel``),
kept under the same class name so a config validates identically in both
packages: support for the ``"auto"`` sentinel, deprecated-field migration,
and unknown-key warnings.
"""

from typing import Any, ClassVar, Dict

from pydantic import BaseModel, ConfigDict, model_validator

from deepspeed_tpu_torch.utils.logging import logger

#: Sentinel used by HuggingFace integration: values set to "auto" are filled
#: in by the engine at initialize() time (reference: runtime/config.py "auto"
#: resolution for HF Trainer).
AUTO = "auto"


def is_auto(value: Any) -> bool:
    return isinstance(value, str) and value.lower() == AUTO


class TPUConfigModel(BaseModel):
    """Base class for all config models (name kept from the JAX package).

    Mirrors ``DeepSpeedConfigModel`` (reference runtime/config_utils.py):
    - extra keys are collected and warned about, not fatal;
    - ``deprecated_aliases`` maps old key -> new key and migrates values;
    - ``"auto"`` string values are preserved untouched so the engine can
      resolve them later (``resolve_auto``).
    """

    model_config = ConfigDict(extra="allow", validate_assignment=True,
                              arbitrary_types_allowed=True, populate_by_name=True)

    #: subclasses may override: {old_field_name: new_field_name}
    deprecated_aliases: ClassVar[Dict[str, str]] = {}

    @model_validator(mode="before")
    @classmethod
    def _migrate_deprecated(cls, values: Any) -> Any:
        if not isinstance(values, dict):
            return values
        for old, new in cls.deprecated_aliases.items():
            if old in values:
                logger.warning("Config field '%s' is deprecated; use '%s'", old, new)
                if new not in values:
                    values[new] = values.pop(old)
                else:
                    values.pop(old)
        return values

    @model_validator(mode="after")
    def _warn_extra(self) -> "TPUConfigModel":
        extra = getattr(self, "model_extra", None) or {}
        for key in extra:
            logger.warning("Unknown config key '%s' in %s (ignored)", key,
                           type(self).__name__)
        return self

    def resolve_auto(self, field: str, value: Any) -> None:
        """Fill in a field that was left as "auto" in user config."""
        if is_auto(getattr(self, field, None)):
            setattr(self, field, value)

    def dict_without_auto(self) -> Dict[str, Any]:
        return {k: v for k, v in self.model_dump().items() if not is_auto(v)}


def get_scalar_param(config_dict: Dict[str, Any], name: str, default: Any) -> Any:
    """Reference-compatible helper (runtime/config_utils.py:get_scalar_param)."""
    return config_dict.get(name, default)
