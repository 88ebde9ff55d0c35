"""The language-model stack: dense attention families for serving."""
