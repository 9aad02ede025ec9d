"""Static HTML documentation build (the reference ships a sphinx build;
here the same role is a dependency-light renderer over the executable
markdown docs — every ```python block in docs/*.md is run by
tests/test_docs_examples.py, so the built pages show verified code).

Usage: python docs/build.py [outdir]     (default docs/_build)
"""

import os
import re
import sys

import markdown

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (source path relative to repo root, output name, nav title)
PAGES = [
    ("README.md", "index.html", "Overview"),
    ("docs/index.md", "guide.html", "Guide"),
    ("docs/usage.md", "usage.html", "Usage"),
    ("docs/precision.md", "precision.html", "Precision"),
    ("PARITY.md", "parity.html", "Reference parity"),
    ("CHANGELOG.md", "changelog.html", "Changelog"),
]

_STYLE = """
body { font-family: system-ui, sans-serif; max-width: 58rem;
       margin: 2rem auto; padding: 0 1rem; line-height: 1.55;
       color: #1c2733; }
nav { border-bottom: 1px solid #d8dee6; padding-bottom: .6rem;
      margin-bottom: 1.6rem; }
nav a { margin-right: 1.1rem; color: #205a9e; text-decoration: none; }
pre { background: #f4f6f8; padding: .8rem; overflow-x: auto;
      border-radius: 6px; }
code { background: #f4f6f8; padding: .08rem .25rem; border-radius: 4px; }
pre code { padding: 0; }
table { border-collapse: collapse; }
th, td { border: 1px solid #d8dee6; padding: .3rem .6rem; }
h1, h2, h3 { color: #14202c; }
"""

_LINK_MAP = {src.split("/")[-1]: out for src, out, _ in PAGES}


def _rewrite_links(html):
    """Point intra-repo ``*.md`` links at their built pages."""
    def sub(m):
        target = m.group(2).split("/")[-1]
        return m.group(1) + _LINK_MAP.get(target, m.group(2)) + '"'
    return re.sub(r'(href=")([^"#]+\.md)"', sub, html)


def build(outdir=None):
    outdir = outdir or os.path.join(ROOT, "docs", "_build")
    os.makedirs(outdir, exist_ok=True)
    nav = "".join(f'<a href="{out}">{title}</a>'
                  for _, out, title in PAGES)
    written = []
    for src, out, title in PAGES:
        with open(os.path.join(ROOT, src)) as fh:
            body = markdown.markdown(
                fh.read(), extensions=["fenced_code", "tables"])
        page = (f"<!doctype html><html><head><meta charset='utf-8'>"
                f"<title>muse-psfr-tpu — {title}</title>"
                f"<style>{_STYLE}</style></head><body>"
                f"<nav>{nav}</nav>{_rewrite_links(body)}</body></html>")
        path = os.path.join(outdir, out)
        with open(path, "w") as fh:
            fh.write(page)
        written.append(path)
    return written


if __name__ == "__main__":
    out = build(sys.argv[1] if len(sys.argv) > 1 else None)
    print(f"built {len(out)} pages -> {os.path.dirname(out[0])}")
