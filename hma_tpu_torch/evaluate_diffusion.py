"""The continuous evaluator under its other name,
`python -m hma_tpu_torch.evaluate_diffusion` (counterpart of
hma_tpu/evaluate_diffusion.py): the reference calls it evaluate_diffusion.py
while its README names evaluate_feature.py; both names work."""

from hma_tpu_torch.evaluate_feature import load_mar_model, main, parse_args  # noqa: F401

if __name__ == "__main__":
    main()
