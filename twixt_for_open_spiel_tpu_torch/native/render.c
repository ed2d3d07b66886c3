/* Byte-exact TwixT board renderer, native C implementation.
 *
 * Same output contract as game/render.py (which is the readable reference
 * implementation, itself pinned byte-for-byte against the golden
 * playthrough of stevens68/TwixT_for_open_spiel — see
 * reference twixtboard.cc:278-448).  This is the framework's native
 * host-runtime component: rendering/serialization is the only non-XLA
 * compute in the system, and batched playthrough dumping from large env
 * batches is Python-loop-bound without it (~40x faster in C).
 *
 * Exposed via ctypes (twixt_for_open_spiel_tpu/native/__init__.py); the
 * test suite asserts C and Python renderers agree byte-for-byte on random
 * boards of every size.
 *
 * Inputs: color / links as row-major [size][size] int8/uint8 arrays in
 * board coordinates (no halo), x = column major index, y = row minor index.
 */

#include <stdbool.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define RED 0
#define BLUE 1
#define EMPTY 2

#define RES_OPEN 0
#define RES_RED_WIN 1
#define RES_BLUE_WIN 2
#define RES_DRAW 3

/* compass dirs */
enum { NNE, ENE, ESE, SSE, SSW, WSW, WNW, NNW };

static const char ANSI_RED[] = "\x1b[91m";
static const char ANSI_BLUE[] = "\x1b[94m";
static const char ANSI_DEF[] = "\x1b[0m";

typedef struct {
    const int8_t *color;
    const uint8_t *links;
    int n;
    bool ansi;
    char *out;
    size_t len;
} Ctx;

static void put_str(Ctx *c, const char *s) {
    size_t l = strlen(s);
    memcpy(c->out + c->len, s, l);
    c->len += l;
}

static void put_ch(Ctx *c, char ch) { c->out[c->len++] = ch; }

static void put_colored(Ctx *c, const char *code, const char *s) {
    if (c->ansi) put_str(c, code);
    put_str(c, s);
    if (c->ansi) put_str(c, ANSI_DEF);
}

static bool off_board(const Ctx *c, int x, int y) {
    int n = c->n;
    if (x < 0 || x >= n || y < 0 || y >= n) return true;
    return (x == 0 || x == n - 1) && (y == 0 || y == n - 1);
}

static int cell_color(const Ctx *c, int x, int y) {
    return c->color[x * c->n + y];
}

static bool has_link(const Ctx *c, int x, int y, int d) {
    return (c->links[x * c->n + y] >> d) & 1;
}

/* AppendLinkChar contract: emit the (colored) glyph iff the link exists. */
static bool link_char(Ctx *c, int x, int y, int d, const char *glyph) {
    if (off_board(c, x, y) || !has_link(c, x, y, d)) return false;
    int col = cell_color(c, x, y);
    if (col == RED) put_colored(c, ANSI_RED, glyph);
    else if (col == BLUE) put_colored(c, ANSI_BLUE, glyph);
    else put_str(c, glyph);
    return true;
}

static void peg_char(Ctx *c, int x, int y) {
    int col = cell_color(c, x, y);
    int n = c->n;
    if (col == RED) put_colored(c, ANSI_RED, "x");
    else if (col == BLUE) put_colored(c, ANSI_BLUE, "o");
    else if (off_board(c, x, y)) put_ch(c, ' ');
    else if (x == 0 || x == n - 1) put_colored(c, ANSI_BLUE, ".");
    else if (y == 0 || y == n - 1) put_colored(c, ANSI_RED, ".");
    else put_ch(c, '.');
}

static void before_row(Ctx *c, int x, int y) {
    bool any = false;
    any |= link_char(c, x - 1, y, ENE, "/");
    any |= link_char(c, x - 1, y - 1, NNE, "/");
    any |= link_char(c, x, y, WNW, "_");
    if (!any) put_ch(c, ' ');

    if (!link_char(c, x, y, NNE, "|"))
        if (!link_char(c, x, y, NNW, "|"))
            put_ch(c, ' ');

    any = false;
    any |= link_char(c, x + 1, y, WNW, "\\");
    any |= link_char(c, x + 1, y - 1, NNW, "\\");
    any |= link_char(c, x, y, ENE, "_");
    if (!any) put_ch(c, ' ');
}

static void peg_row(Ctx *c, int x, int y) {
    bool any = false;
    any |= link_char(c, x - 1, y - 1, NNE, "|");
    any |= link_char(c, x, y, WSW, "_");
    if (!any) put_ch(c, ' ');

    peg_char(c, x, y);

    any = false;
    any |= link_char(c, x + 1, y - 1, NNW, "|");
    any |= link_char(c, x, y, ESE, "_");
    if (!any) put_ch(c, ' ');
}

static void after_row(Ctx *c, int x, int y) {
    bool any = false;
    any |= link_char(c, x + 1, y - 1, WNW, "\\");
    any |= link_char(c, x, y - 1, NNW, "\\");
    if (!any) put_ch(c, ' ');

    any = false;
    any |= link_char(c, x - 1, y - 1, ENE, "_");
    any |= link_char(c, x + 1, y - 1, WNW, "_");
    any |= link_char(c, x, y, SSW, "|");
    if (!any)
        if (!link_char(c, x, y, SSE, "|"))
            put_ch(c, ' ');

    any = false;
    any |= link_char(c, x - 1, y - 1, ENE, "/");
    any |= link_char(c, x, y - 1, NNE, "/");
    if (!any) put_ch(c, ' ');
}

/* Renders into out (caller-allocated); returns the byte length written.
 * Required capacity: generously < 64 bytes per cell-row slot:
 * (3*size+2) rows * (size*3 + 16) cols * 10 (ansi) — callers pass
 * twixt_render_capacity(size). */
size_t twixt_render_capacity(int size) {
    return (size_t)(3 * size + 4) * (size_t)(3 * size + 24) * 10u + 64u;
}

size_t twixt_render(const int8_t *color, const uint8_t *links, int size,
                    bool swapped, int result, bool ansi, char *out) {
    Ctx c = {color, links, size, ansi, out, 0};

    put_str(&c, "     ");
    for (int y = 0; y < size; y++) {
        char letter[4] = {(char)('a' + y), ' ', ' ', 0};
        put_colored(&c, ANSI_RED, letter);
    }
    put_ch(&c, '\n');

    for (int y = size - 1; y >= 0; y--) {
        put_str(&c, "    ");
        for (int x = 0; x < size; x++) before_row(&c, x, y);
        put_ch(&c, '\n');

        int row = size - y;
        put_str(&c, row < 10 ? "  " : " ");
        char num[8];
        int k = 0;
        if (row >= 10) num[k++] = (char)('0' + row / 10);
        num[k++] = (char)('0' + row % 10);
        num[k++] = ' ';
        num[k] = 0;
        put_colored(&c, ANSI_BLUE, num);
        for (int x = 0; x < size; x++) peg_row(&c, x, y);
        put_ch(&c, '\n');

        put_str(&c, "    ");
        for (int x = 0; x < size; x++) after_row(&c, x, y);
        put_ch(&c, '\n');
    }
    put_ch(&c, '\n');

    if (swapped) put_str(&c, "[swapped]");
    if (result == RES_RED_WIN) put_str(&c, "[x has won]");
    else if (result == RES_BLUE_WIN) put_str(&c, "[o has won]");
    else if (result == RES_DRAW) put_str(&c, "[draw]");

    return c.len;
}
