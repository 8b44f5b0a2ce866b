from .adamw import AdamW, AdamState, cosine_schedule  # noqa
