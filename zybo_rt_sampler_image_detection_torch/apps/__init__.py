from . import pipeline
