from .zoo import MODEL_ZOO, DeepFuse, create_model

__all__ = ["DeepFuse", "MODEL_ZOO", "create_model"]
