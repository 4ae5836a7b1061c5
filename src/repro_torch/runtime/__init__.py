from .server import InferenceServer, Request, Result

__all__ = ["InferenceServer", "Request", "Result"]
