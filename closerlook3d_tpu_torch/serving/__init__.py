"""Serving: answer classification and segmentation requests, from the
model's code (``Predictor``) or from an exported artifact
(``export_forward``, ``load_forward``).

The names load lazily, so that importing the loader pulls in no model
code.
"""

_EXPORTS = {"Predictor": "predictor", "export_forward": "export",
            "load_forward": "export", "ExportedPredictor": "export"}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
