from .evaluate import evaluate_bundle, evaluate_model
