"""Entry points of the language-model stack."""
