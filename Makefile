# (reference: Makefile test/pep8 targets)

.PHONY: test lint bench all

test:
	python -m pytest tests/ -q

lint:
	@python -m flake8 deepblast_jax tests --max-line-length 100 2>/dev/null \
	 || python -m pyflakes deepblast_jax tests 2>/dev/null \
	 || echo "no linter installed (flake8/pyflakes); skipping"

bench:
	python bench.py

all: lint test
