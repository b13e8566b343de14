"""Cursor-driven terminal selection menu for the config questionnaire.

Counterpart of ``accelerate_tpu/commands/menu.py`` (its own copy: the port
imports nothing of the JAX package). Arrow keys or j / k move a
highlight, digits jump, Enter confirms, Ctrl-C / Esc / q cancels back to
the default. When stdin or stdout is not a TTY (pipes, CI, tests) it asks
a plain numbered prompt instead, so every caller can use it
unconditionally.

Key decoding and cursor movement are pure functions over a small state,
testable without a terminal.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

# ANSI bits kept inline: the menu must not depend on rich/curses.
_HIDE_CURSOR = "\033[?25l"
_SHOW_CURSOR = "\033[?25h"
_CLEAR_LINE = "\033[2K"
_UP = "\033[1A"
_HIGHLIGHT = "\033[7m"  # reverse video
_RESET = "\033[0m"


@dataclass
class MenuState:
    n: int
    pos: int = 0
    done: bool = False
    cancelled: bool = False


# Decoded key names; escape sequences for arrows arrive as ESC [ A/B.
KEY_UP, KEY_DOWN, KEY_ENTER, KEY_CANCEL = "up", "down", "enter", "cancel"


def decode_key(seq: str) -> str:
    """Map a raw keypress (possibly a multi-byte escape sequence) to an
    action name; unrecognized keys map to themselves (single char)."""
    if seq in ("\x1b[A", "k"):
        return KEY_UP
    if seq in ("\x1b[B", "j"):
        return KEY_DOWN
    if seq in ("\r", "\n"):
        return KEY_ENTER
    if seq in ("\x03", "\x1b", "q"):
        return KEY_CANCEL
    return seq


def step_state(state: MenuState, key: str) -> MenuState:
    """Advance the menu state by one decoded keypress (pure)."""
    if key == KEY_UP:
        state.pos = (state.pos - 1) % state.n
    elif key == KEY_DOWN:
        state.pos = (state.pos + 1) % state.n
    elif key == KEY_ENTER:
        state.done = True
    elif key == KEY_CANCEL:
        state.done = state.cancelled = True
    elif key.isdigit() and 0 < int(key) <= state.n:
        state.pos = int(key) - 1
    return state


def _pending_input(fd, timeout: float = 0.05) -> bool:
    import select as _select

    ready, _, _ = _select.select([fd], [], [], timeout)
    return bool(ready)


def _read_key(fd: int) -> str:
    """Read one keypress directly from the fd.

    Must be ``os.read``, not ``sys.stdin.read``: the TextIOWrapper's
    read-ahead would pull an escape sequence's tail bytes into Python's
    userspace buffer, where the ``select()`` below cannot see them — every
    arrow key would then decode as a bare ESC (= cancel)."""
    import os as _os

    ch = _os.read(fd, 1).decode(errors="replace")
    if ch == "\x1b":
        # A CSI sequence delivers its remaining bytes immediately; a bare ESC
        # press delivers nothing more. Distinguish without blocking so ESC
        # cancels on its own and never swallows the next keypress.
        if not _pending_input(fd):
            return ch
        rest = _os.read(fd, 2).decode(errors="replace")
        return ch + rest  # "[A"-style CSI tail, or an ESC+x chord
    return ch


def _render(question: str, choices: list[str], pos: int, first: bool, out) -> None:
    if not first:
        out.write((_UP + _CLEAR_LINE) * (len(choices) + 1) + "\r")
    out.write(f"{question} (arrows/jk move, Enter selects)\n")
    for i, choice in enumerate(choices):
        marker = f"{_HIGHLIGHT} > {choice} {_RESET}" if i == pos else f"   {choice}"
        out.write(_CLEAR_LINE + marker + "\n")
    out.flush()


def _interactive_select(question: str, choices: list[str], default_index: int) -> int:
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    state = MenuState(n=len(choices), pos=default_index)
    out = sys.stdout
    out.write(_HIDE_CURSOR)
    try:
        tty.setcbreak(fd)
        first = True
        while not state.done:
            # cbreak keeps ISIG, so Ctrl-C arrives as KeyboardInterrupt —
            # anywhere in the render/read cycle. It means "cancel".
            try:
                _render(question, choices, state.pos, first, out)
                first = False
                key = decode_key(_read_key(fd))
            except KeyboardInterrupt:
                key = KEY_CANCEL
            state = step_state(state, key)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        out.write(_SHOW_CURSOR)
        out.flush()
    if state.cancelled:
        print(f"-> {choices[default_index]} (default)")
        return default_index
    print(f"-> {choices[state.pos]}")
    return state.pos


def _prompt_select(question: str, choices: list[str], default_index: int) -> int:
    print(question)
    for i, choice in enumerate(choices):
        print(f"  [{i + 1}] {choice}")
    try:
        raw = input(f"Choice (1-{len(choices)}) [{default_index + 1}]: ").strip()
    except EOFError:
        raw = ""
    if raw.isdigit() and 0 < int(raw) <= len(choices):
        return int(raw) - 1
    if raw in choices:
        return choices.index(raw)
    return default_index


def select(question: str, choices: list[str], default: str | None = None) -> str:
    """Ask the user to pick one of ``choices``; returns the chosen string.

    Cursor menu on a real terminal, numbered prompt otherwise — so wizard
    code can call this unconditionally (CI pipes, notebooks, tests).
    """
    default_index = choices.index(default) if default in choices else 0
    try:
        interactive = sys.stdin.isatty() and sys.stdout.isatty()
    except (ValueError, OSError):
        interactive = False
    if interactive:
        try:
            return choices[_interactive_select(question, choices, default_index)]
        except (ImportError, OSError, _TERMIOS_ERROR):
            pass  # fall through to the plain prompt
    return choices[_prompt_select(question, choices, default_index)]


try:
    import termios as _termios

    _TERMIOS_ERROR = _termios.error
except ImportError:  # non-POSIX: termios missing entirely
    _TERMIOS_ERROR = OSError
