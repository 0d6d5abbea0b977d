"""The LM stack's serving half (dense GQA decoders), ported from
``repro/models``."""
