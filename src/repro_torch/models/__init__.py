"""Models of the port: the config dataclass (a copy of
``repro.models.config``), the dense layers (``layers``) and the dense LM
(``lm``)."""
