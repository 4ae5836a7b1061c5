from .server import InferenceServer, Request, Result, attach_serving_executor

__all__ = ["InferenceServer", "Request", "Result", "attach_serving_executor"]
