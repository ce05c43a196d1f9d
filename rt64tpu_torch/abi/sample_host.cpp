/*
 * Headless sample host of rt64tpu_torch — the src/sample/main.cpp analog,
 * linked against librt64tpu_torch.so.
 *
 * Exercises the full C ABI like the reference's runtime smoke test
 * (main.cpp:201-412): device + scene + view, a procedural sphere and
 * floor, a combiner shader, an RGBA8 texture, a sun light, per-frame
 * SetInstanceDescription updates, a few DrawDevice calls, picking, and
 * a PPM dump of the final frame via the pull-based present.
 */

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "rt64_tpu.h"

namespace {

struct Vertex {
    float pos[4];
    float nrm[3];
    float uv[2];
    float col[3]; /* combiner INPUT_1, float3 (no opt_alpha) */
};

void make_sphere(std::vector<Vertex> &verts, std::vector<unsigned> &idx,
                 float radius, int rings, int sectors) {
    for (int r = 0; r <= rings; ++r) {
        float phi = static_cast<float>(M_PI) * r / rings;
        for (int s = 0; s <= sectors; ++s) {
            float theta = 2.0f * static_cast<float>(M_PI) * s / sectors;
            Vertex v{};
            float nx = std::sin(phi) * std::cos(theta);
            float ny = std::cos(phi);
            float nz = std::sin(phi) * std::sin(theta);
            v.pos[0] = nx * radius;
            v.pos[1] = ny * radius;
            v.pos[2] = nz * radius;
            v.pos[3] = 1.0f;
            v.nrm[0] = nx;
            v.nrm[1] = ny;
            v.nrm[2] = nz;
            v.uv[0] = static_cast<float>(s) / sectors;
            v.uv[1] = static_cast<float>(r) / rings;
            v.col[0] = v.col[1] = v.col[2] = 1.0f;
            verts.push_back(v);
        }
    }
    int cols = sectors + 1;
    for (int r = 0; r < rings; ++r) {
        for (int s = 0; s < sectors; ++s) {
            unsigned a = r * cols + s;
            unsigned b = a + cols;
            unsigned quad[6] = {a, a + 1, b, a + 1, b + 1, b};
            for (unsigned q : quad) idx.push_back(q);
        }
    }
}

RT64_MATRIX4 identity() {
    RT64_MATRIX4 m;
    std::memset(&m, 0, sizeof(m));
    m.m[0][0] = m.m[1][1] = m.m[2][2] = m.m[3][3] = 1.0f;
    return m;
}

RT64_MATERIAL default_material() {
    RT64_MATERIAL mat;
    std::memset(&mat, 0, sizeof(mat));
    mat.diffuseTexIndex = -1;
    mat.normalTexIndex = -1;
    mat.specularTexIndex = -1;
    mat.uvDetailScale = 1.0f;
    mat.specularColor = {1.0f, 1.0f, 1.0f};
    mat.specularExponent = 25.0f;
    mat.solidAlphaMultiplier = 1.0f;
    mat.shadowAlphaMultiplier = 1.0f;
    mat.lightGroupMaskBits = RT64_LIGHT_GROUP_MASK_ALL;
    return mat;
}

}  // namespace

int main(int argc, char **argv) {
    const char *out_path = argc > 1 ? argv[1] : "sample_host.ppm";

    RT64_DEVICE *device = RT64_CreateDevice(nullptr);
    if (device == nullptr) {
        std::fprintf(stderr, "CreateDevice failed: %s\n", RT64_GetLastError());
        return 1;
    }
    std::printf("PyTorch/CUDA raytracing device was detected!\n");

    RT64_SCENE *scene = RT64_CreateScene(device);
    RT64_VIEW *view = RT64_CreateView(scene);

    /* Checkerboard texture. */
    const int TW = 32, TH = 32;
    std::vector<unsigned char> texels(TW * TH * 4);
    for (int y = 0; y < TH; ++y) {
        for (int x = 0; x < TW; ++x) {
            bool on = ((x / 4 + y / 4) & 1) != 0;
            unsigned char *p = &texels[(y * TW + x) * 4];
            p[0] = p[1] = p[2] = on ? 230 : 40;
            p[3] = 255;
        }
    }
    RT64_TEXTURE_DESC tdesc{};
    tdesc.bytes = texels.data();
    tdesc.byteCount = static_cast<int>(texels.size());
    tdesc.format = RT64_TEXTURE_FORMAT_RGBA8;
    tdesc.width = TW;
    tdesc.height = TH;
    tdesc.rowPitch = TW * 4;
    RT64_TEXTURE *texture = RT64_CreateTexture(device, tdesc);

    /* Combiner: color = TEXEL0 (single path: c[0][3] = TEXEL0 = 5). */
    unsigned shaderId = 5u << 9 | 5u << 21;
    RT64_SHADER *shader = RT64_CreateShader(
        device, shaderId, RT64_SHADER_FILTER_LINEAR, RT64_SHADER_ADDRESSING_WRAP,
        RT64_SHADER_ADDRESSING_WRAP, RT64_SHADER_RAYTRACE_ENABLED);
    /* Vertex-color combiner for the floor: color = INPUT_1. */
    RT64_SHADER *floorShader = RT64_CreateShader(
        device, 1u << 9 | 1u << 21, RT64_SHADER_FILTER_POINT,
        RT64_SHADER_ADDRESSING_WRAP, RT64_SHADER_ADDRESSING_CLAMP,
        RT64_SHADER_RAYTRACE_ENABLED);

    /* Sphere mesh. */
    std::vector<Vertex> sv;
    std::vector<unsigned> si;
    make_sphere(sv, si, 1.5f, 16, 24);
    RT64_MESH *sphere = RT64_CreateMesh(
        device, RT64_MESH_RAYTRACE_ENABLED | RT64_MESH_RAYTRACE_FAST_TRACE);
    RT64_SetMesh(sphere, sv.data(), static_cast<int>(sv.size()), sizeof(Vertex),
                 si.data(), static_cast<int>(si.size()));

    /* Floor quad. The vertex layout is SHADER-defined (VertexLayout,
     * rt64_shader.cpp:80-96): the floor's combiner uses no textures, so
     * its layout has no UV field — pos4 + nrm3 + input1 float3. */
    struct FloorVertex {
        float pos[4];
        float nrm[3];
        float col[3];
    };
    FloorVertex fv[4] = {};
    const float ext = 8.0f;
    float xs[4] = {-ext, ext, ext, -ext};
    float zs[4] = {-ext, -ext, ext, ext};
    for (int i = 0; i < 4; ++i) {
        fv[i].pos[0] = xs[i];
        fv[i].pos[2] = zs[i];
        fv[i].pos[3] = 1.0f;
        fv[i].nrm[1] = 1.0f;
        fv[i].col[0] = 0.75f;
        fv[i].col[1] = 0.72f;
        fv[i].col[2] = 0.70f;
    }
    unsigned fi[6] = {0, 2, 1, 0, 3, 2};
    RT64_MESH *floor = RT64_CreateMesh(
        device, RT64_MESH_RAYTRACE_ENABLED | RT64_MESH_RAYTRACE_UPDATABLE);
    RT64_SetMesh(floor, fv, 4, sizeof(FloorVertex), fi, 6);

    /* Instances. */
    RT64_INSTANCE *sphereInst = RT64_CreateInstance(scene);
    RT64_INSTANCE *floorInst = RT64_CreateInstance(scene);

    RT64_LIGHT light{};
    light.position = {15.0f, 20.0f, 8.0f};
    light.diffuseColor = {0.9f, 0.85f, 0.75f};
    light.attenuationRadius = 10000.0f;
    light.pointRadius = 1.5f;
    light.specularColor = {0.7f, 0.65f, 0.6f};
    light.attenuationExponent = 1.0f;
    light.groupBits = RT64_LIGHT_GROUP_DEFAULT;
    RT64_SetSceneLights(scene, &light, 1);

    RT64_SCENE_DESC sd{};
    sd.ambientBaseColor = {0.25f, 0.25f, 0.3f};
    sd.skyDiffuseMultiplier = {1.0f, 1.0f, 1.0f};
    sd.giDiffuseStrength = 0.7f;
    sd.giSkyStrength = 0.35f;
    RT64_SetSceneDescription(scene, sd);

    RT64_VIEW_DESC vd{};
    vd.resolutionScale = 1.0f;
    vd.diSamples = 1;
    vd.giSamples = 1;
    vd.maxLights = 4;
    vd.upscaler = RT64_UPSCALER_OFF;
    RT64_SetViewDescription(view, vd);

    /* Camera: looking at the sphere from (0, 3, 9). */
    RT64_MATRIX4 viewMatrix = identity();
    viewMatrix.m[3][0] = 0.0f;
    viewMatrix.m[3][1] = -3.0f;
    viewMatrix.m[3][2] = -9.0f;

    for (int frame = 0; frame < 3; ++frame) {
        RT64_SetViewPerspective(view, viewMatrix, 45.0f * 3.14159265f / 180.0f,
                                0.1f, 1000.0f, true);
        RT64_INSTANCE_DESC inst{};
        inst.mesh = sphere;
        inst.transform = identity();
        inst.transform.m[3][1] = 1.5f;
        inst.previousTransform = inst.transform;
        inst.diffuseTexture = texture;
        inst.shader = shader;
        inst.material = default_material();
        inst.material.reflectionFactor = 0.3f;
        inst.material.reflectionFresnelFactor = 0.4f;
        RT64_SetInstanceDescription(sphereInst, inst);

        RT64_INSTANCE_DESC finst{};
        finst.mesh = floor;
        finst.transform = identity();
        finst.previousTransform = finst.transform;
        finst.shader = floorShader;
        finst.material = default_material();
        RT64_SetInstanceDescription(floorInst, finst);

        RT64_DrawDevice(device, 1, 1000.0f / 60.0f);
    }

    int w = 0, h = 0;
    RT64_GetViewFrameSize(view, &w, &h);
    std::vector<unsigned char> pixels(static_cast<size_t>(w) * h * 4);
    if (!RT64_GetViewFramePixels(view, pixels.data(), pixels.size())) {
        std::fprintf(stderr, "GetViewFramePixels failed: %s\n",
                     RT64_GetLastError());
        return 1;
    }

    /* Picking smoke test (GetViewRaytracedInstanceAt analog of
     * main.cpp:76-83). */
    RT64_INSTANCE *picked = RT64_GetViewRaytracedInstanceAt(view, w / 2, h / 2);
    std::printf("picked instance at center: %s\n",
                picked == sphereInst ? "sphere" : picked ? "other" : "none");

    FILE *f = std::fopen(out_path, "wb");
    std::fprintf(f, "P6\n%d %d\n255\n", w, h);
    for (int i = 0; i < w * h; ++i) {
        std::fwrite(&pixels[i * 4], 1, 3, f);
    }
    std::fclose(f);
    std::printf("wrote %s (%dx%d)\n", out_path, w, h);

    RT64_DestroyInstance(sphereInst);
    RT64_DestroyInstance(floorInst);
    RT64_DestroyMesh(sphere);
    RT64_DestroyMesh(floor);
    RT64_DestroyShader(shader);
    RT64_DestroyShader(floorShader);
    RT64_DestroyTexture(texture);
    RT64_DestroyView(view);
    RT64_DestroyScene(scene);
    RT64_DestroyDevice(device);
    return 0;
}
