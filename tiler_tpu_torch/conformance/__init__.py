"""Reference-decoder conformance: a mini-JS engine (jsvm) that runs the
unchanged gtm.player.js + js-lzma files, and the browser-surface harness
(player) that drives them. BASELINE.md: output must be bit-playable by the
unchanged reference decoder."""
from .player import decode_with_reference_player  # noqa: F401
